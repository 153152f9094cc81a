"""Every f32 product on the device path asks for Precision.HIGHEST.

On a GPU an f32 dot without it may run in TF32 (~3 decimal digits), which
cannot meet the >70 dB contract against the reference.  These tests walk
the jaxpr of each device program the pipelines dispatch and check every
``dot_general``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from doppler_tpu.ops.multistage import MultiStageResampler
from doppler_tpu.ops.resample import (
    RationalResampler,
    conv_stream_geometry,
    make_taps_matrix,
    resample_conv_stream,
)
from doppler_tpu.parallel import make_mesh


def _dot_precisions(jaxpr):
    """Precision params of every dot_general, sub-jaxprs included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _dot_precisions(inner)
    return found


def _conv_args(st, C=None, N=8192):
    M = st.max_out_for(N)
    s0, p0, K, PADZ, TAIL = conv_stream_geometry(0, 0, M, N, P=st.P, Q=st.Q,
                                                 T=st.T)
    shape = (N + st.T - 1,) if C is None else (C, N + st.T - 1)
    x = jnp.zeros(shape, jnp.float32)
    taps = jnp.asarray(make_taps_matrix(st.bank, st.P, st.Q))
    kw = dict(P=st.P, Q=st.Q, T=st.T, K=K, M=M, PADZ=PADZ, TAIL=TAIL)
    return (x, x, taps, jnp.int32(s0), jnp.int32(p0)), kw


def _stream_program():
    st = RationalResampler(1_024_000, 48000)
    args, kw = _conv_args(st)
    return jax.make_jaxpr(lambda *a: resample_conv_stream(*a, **kw))(*args)


def _cascade_program():
    stages = [st for st in MultiStageResampler(100_000_000, 48000).stages
              if st.impl == "conv"]

    def fn(x):
        out = []
        for st in stages:
            args, kw = _conv_args(st)
            out.append(resample_conv_stream(x[:args[0].shape[0]], *args[1:],
                                            **kw))
        return out
    return jax.make_jaxpr(fn)(jnp.zeros(9000, jnp.float32))


def _channels_program():
    st = RationalResampler(1_024_000, 48000, channels=4)
    args, kw = _conv_args(st, C=4)
    return jax.make_jaxpr(lambda *a: resample_conv_stream(*a, **kw))(*args)


def _sharded_stream_program():
    from doppler_tpu.parallel.sharded import make_wideband_stream_step

    rs = RationalResampler(1_024_000, 48000)
    assert rs.impl == "conv"
    step = make_wideband_stream_step(make_mesh(time=2), intype="i16",
                                     outtype="i16", C=1, resampler=rs)
    B, L = 4, 2048
    args = ([jnp.zeros((B, L), jnp.int32)]
            + [jnp.zeros((1, B), jnp.uint32)] * 7
            + [jnp.zeros((1, rs.T - 1), jnp.float32)] * 2
            + [jnp.zeros(2, jnp.int32)] * 2)
    return jax.make_jaxpr(step)(*args)


def _sharded_cascade_program():
    from doppler_tpu.parallel.sharded import make_cascade_channels_step

    ms = MultiStageResampler(100_000_000, 48000, channels=2)
    step = make_cascade_channels_step(make_mesh(channel=2), intype="i16",
                                      outtype="f32", C=2, resampler=ms)
    B, L = 4, 2048
    args = ([jnp.zeros((B, L), jnp.int32)]
            + [jnp.zeros((2, B), jnp.uint32)] * 7
            + [jnp.zeros((2, st.T - 1), jnp.float32)
               for st in ms.stages for _ in range(2)]
            + [jnp.int32(0)] * (3 * len(ms.stages)))
    return jax.make_jaxpr(step)(*args)


def _entry_program():
    import __graft_entry__ as ge

    fn, ex = ge.entry()
    return jax.make_jaxpr(fn)(*ex)


@pytest.mark.parametrize("program", [
    _stream_program, _cascade_program, _channels_program,
    _sharded_stream_program, _sharded_cascade_program, _entry_program,
], ids=["stream", "cascade", "channels", "sharded-stream",
        "sharded-cascade", "graft-entry"])
def test_every_dot_is_highest(program):
    precs = _dot_precisions(program().jaxpr)
    assert precs, "program has no dot_general to check"
    hi = jax.lax.Precision.HIGHEST
    assert all(p == (hi, hi) for p in precs), precs


def test_entry_compiles_without_an_interpreter():
    """``entry()`` is the XLA chunk program itself: no Pallas call, and it
    runs on the default backend."""
    import __graft_entry__ as ge

    fn, ex = ge.entry()
    assert "pallas_call" not in str(jax.make_jaxpr(fn)(*ex))
    out = np.asarray(jax.jit(fn)(*ex))
    rs = RationalResampler(1_024_000, 48000)
    assert out.shape == (rs.max_out_for(8 * 8192),)
    assert out.dtype == np.int32
