"""Polyphase rational resampler — streaming, stateless-on-device.

The capability half of liquid-dsp's ``msresamp`` (SURVEY §2 #10; BASELINE
config 3: 1.024 Msps → 48 ksps).  Array formulation: every output sample
is a *pure function of its absolute output index m*,

    y[m] = Σ_{l<T} bank[(m·Q) mod P, l] · x[⌊m·Q/P⌋ − l]

so the output axis shards exactly like the mixer's time axis; the only
sequential state is the T−1-sample input history at block boundaries
(overlap-save) and the next output index — integers, so *resume = seek*
(SURVEY §5 checkpointing).

The device kernel is a gather + per-output dot over fixed shapes: the host
passes the absolute alignment as two scalars (phase remainder and history
offset), so one compilation serves the whole stream including the padded
tail.  Output counts per chunk vary by ±1 sample (Bresenham-style); the
device always computes the fixed maximum and the host slices the valid run.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from doppler_tpu.ops.filters import design_polyphase_bank

__all__ = [
    "RationalResampler",
    "resample_oracle",
    "window_dot",
    "resample_conv_stream",
    "conv_stream_geometry",
]


def _tree_sum_last(x):
    """Fixed-order pairwise sum over the last axis.

    ``jnp.sum`` lowers to an XLA ``reduce`` whose association order is
    backend/shape/fusion dependent; the resulting 1-ulp differences break
    the pinned bitwise equality between the streaming, chunked, and
    mesh-sharded paths (SURVEY §4c).  An explicit power-of-two pairwise
    tree is a chain of ordinary f32 adds — IEEE-exact per HLO op — so every
    path rounds identically regardless of batch shape or sharding.
    """
    n = x.shape[-1]
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, p - n)])
    while x.shape[-1] > 1:
        x = x[..., ::2] + x[..., 1::2]
    return x[..., 0]


def window_dot(xi, xq, bank_rev, rem0, off0, *, P, Q, T, M):
    """Resample M outputs from a padded input window — the one formulation.

    Shared by the streaming path (below) and the mesh-sharded step
    (``parallel.sharded``): both build the *same* jnp graph with a
    fixed-order tap reduction, so a sharded run reproduces the
    single-device run bitwise (SURVEY §4c).

    ``xi, xq``    : (..., H + N) planar input, where index 0 sits T−1 samples
                    before the first output's newest-needed sample.
    ``bank_rev``  : (P, T) bank with taps reversed (so the window dot is a
                    forward gather: y = Σ_l rev[p, l] · x[base + l]).
    ``rem0``      : (m0·Q) mod P for the first output index m0.
    ``off0``      : position of ⌊m0·Q/P⌋ − (T−1) within the input window.
    """
    j = jnp.arange(M, dtype=jnp.int32)
    u = j * jnp.int32(Q) + rem0.astype(jnp.int32)      # upsampled offsets
    local_n = u // jnp.int32(P)                        # input advance vs m0
    phase = u % jnp.int32(P)
    base = off0.astype(jnp.int32) + local_n            # window start, (M,)
    idx = base[:, None] + jnp.arange(T, dtype=jnp.int32)[None, :]
    wi = jnp.take(xi, idx, axis=-1, mode="clip")       # (..., M, T)
    wq = jnp.take(xq, idx, axis=-1, mode="clip")
    taps = jnp.take(bank_rev, phase, axis=0)           # (M, T)
    yi = _tree_sum_last(wi * taps)
    yq = _tree_sum_last(wq * taps)
    return yi, yq


@partial(jax.jit, static_argnames=("P", "Q", "T", "M"))
def _resample_kernel(xi, xq, bank_rev, rem0, off0, *, P, Q, T, M):
    return window_dot(xi, xq, bank_rev, rem0, off0, P=P, Q=Q, T=T, M=M)


@partial(jax.jit, static_argnames=("P", "Q", "T", "K", "M", "PADZ", "TAIL"))
def resample_conv_stream(xi, xq, taps_mat, start0, p0,
                         *, P, Q, T, K, M, PADZ, TAIL):
    """Streaming banded-matmul resampler — the product path.

    Generalizes :func:`resample_conv_block` to *arbitrary* mid-stream
    alignment: outputs are computed in full polyphase cycles (P consecutive
    outputs per stride-Q window row), so a chunk whose first output index
    m0 sits mid-cycle computes cycle ⌊m0/P⌋ onward and dynamic-slices the
    kept range.  The leading partial cycle's discarded outputs read up to
    ~2Q samples before the T−1 true history — those positions are zero
    padding, which is sound because every KEPT output's taps span exactly
    its own T-window (``taps_mat`` column p is nonzero only on
    [⌊pQ/P⌋, ⌊pQ/P⌋+T)), so pad garbage only ever feeds discarded outputs.

    ``xi/xq``  : ``(..., H + N)`` with the usual T−1-sample history prefix
                 (identical buffer layout to :func:`window_dot`).
    ``start0`` : buffer index (after the PADZ zeros) where cycle ⌊m0/P⌋'s
                 window row begins — host-computed exact int.
    ``p0``     : m0 mod P, the first kept output's offset into cycle 0.
    ``K``      : static cycle count; K·P ≥ p0 + M for any p0 < P.
    ``PADZ/TAIL``: static zero padding (front/back) sized by the host so
                 every window row is in bounds.

    NaN edge: a NaN input sample pollutes every output whose *cycle rows*
    overlap it (≤ w_len neighbors) rather than only its T-window — the
    0·NaN products are not masked.  The gather path (``window_dot``) keeps
    the tighter spread; NaN-carrying f32 streams that need it can select
    ``resample_impl='window'``.
    """
    w_len = (Q - 1) + T
    R = -(-w_len // Q)
    x2 = jnp.stack([xi, xq], axis=-2).reshape(-1, xi.shape[-1])
    x2 = jnp.pad(x2, ((0, 0), (PADZ, TAIL)))
    G = jax.lax.dynamic_slice_in_dim(
        x2, start0 + jnp.int32(PADZ), (K + R) * Q, axis=-1
    ).reshape(-1, K + R, Q)
    taps_pad = jnp.pad(taps_mat, ((0, R * Q - w_len), (0, 0)))
    y = None
    for r in range(R):
        term = jax.lax.dot_general(
            G[:, r : r + K, :], taps_pad[r * Q : (r + 1) * Q],
            dimension_numbers=(((2,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )                                                  # (rows, K, P)
        y = term if y is None else y + term
    y = y.reshape(-1, K * P)
    y = jax.lax.dynamic_slice_in_dim(y, p0, M, axis=-1)
    y = y.reshape(*xi.shape[:-1], 2, M)
    return y[..., 0, :], y[..., 1, :]


def conv_stream_geometry(m0: int, in_consumed: int, M: int, N: int,
                         *, P: int, Q: int, T: int):
    """Host: exact alignment ints for :func:`resample_conv_stream`.

    Returns ``(start0, p0, K, PADZ, TAIL)`` for a chunk whose buffer is
    [T−1 history | N inputs] with buffer index 0 at absolute input
    ``in_consumed − (T−1)``.  ``start0``/``p0`` are per-chunk (dynamic
    kernel operands); ``K``/``PADZ``/``TAIL`` depend only on (N, M, P, Q, T)
    so the compiled kernel is reused across the stream.  All exact Python
    ints — valid for arbitrary stream position.
    """
    H = T - 1
    i0, p0 = divmod(m0, P)
    # Window row i covers buffer positions [iQ, iQ + w_len) where buffer
    # index 0 sits H samples BEFORE the stream origin (the taps matrix
    # bakes the H offset into each phase's band: column p is nonzero on
    # [⌊pQ/P⌋, ⌊pQ/P⌋+T), whose top tap is the output's newest input).
    # Our chunk buffer index c maps to that global position A + c, so:
    start0 = i0 * Q - in_consumed           # may be < 0 → covered by PADZ
    # Floor K at 64 cycles: XLA's matmul microkernels handle very small
    # contraction batches with different tail code, rounding 1 ulp apart
    # from the large-K case — which would break the pinned bitwise
    # equality between chunkings when a ragged tail chunk is tiny.  K=53
    # vs K=314 were measured bit-identical on CPU; K=2 was not.  The
    # excess cycles read zero padding and are sliced away.
    K = max(64, -(-(P - 1 + M) // P))       # static over p0 < P
    w_len = (Q - 1) + T
    R = -(-w_len // Q)
    # dynamic-range bounds on start0 over the life of the stream:
    #   m0 ≤ ⌈A·P/Q⌉ ⇒ i0·Q ≤ m0·Q/P ≤ A + Q  ⇒ start0 ≤ Q
    #   m0 ≥ (A·P − Q + 1)/Q ⇒ start0 ≥ −2Q − 1  (discarded-cycle reach)
    PADZ = 2 * Q + T                        # static bound on −start0
    TAIL = max(0, Q + (K + R) * Q - (H + N))
    if not (-PADZ <= start0 <= Q):
        raise AssertionError(
            f"conv alignment out of bounds: start0={start0} H={H} Q={Q}"
        )
    return start0, p0, K, PADZ, TAIL


class RationalResampler:
    """Streaming P/Q resampler over planar IQ chunks.

    ``in_rate``/``out_rate`` are reduced to lowest terms; arbitrary rationals
    are supported (the polyphase bank has P phases).  Use ``taps_per_phase``
    and ``atten_db`` to trade filter quality against compute.

    ``impl`` selects the device formulation (identical Bresenham alignment,
    identical taps, different f32 evaluation): ``'conv'`` is the banded
    windows-matmul (cuBLAS products at ``Precision.HIGHEST``); ``'window'``
    is the gather+fixed-tree formulation.  ``'auto'`` (default) picks conv unless
    the band count R = ⌈(Q−1+T)/Q⌉ is large (taps ≫ Q, e.g. halfband
    stages), where the banded decomposition degenerates into an R-long
    loop of skinny matmuls and the gather wins.
    """

    def __init__(
        self,
        in_rate: int,
        out_rate: float,
        *,
        taps_per_phase: int | None = None,
        atten_db: float = 70.0,
        channels: int | None = None,
        max_denominator: int = 1 << 16,
        impl: str = "auto",
    ):
        """Non-integer ``out_rate`` is rationalized to within
        ``1/max_denominator`` relative error (an arbitrary float rate r has
        |P/Q − r·in| ≤ r·in/max_den² by Stern-Brocot best approximation —
        sub-µHz for audio-class rates), covering liquid-dsp's arbitrary-rate
        ``msresamp`` capability with the exact-rational machinery."""
        if in_rate <= 0 or out_rate <= 0:
            raise ValueError("rates must be positive")
        if float(out_rate).is_integer():
            g = math.gcd(int(in_rate), int(out_rate))
            self.P = int(out_rate) // g
            self.Q = int(in_rate) // g
        else:
            from fractions import Fraction

            frac = Fraction(float(out_rate) / float(in_rate)).limit_denominator(
                max_denominator
            )
            self.P = frac.numerator
            self.Q = frac.denominator
        self.in_rate = int(in_rate)
        self.out_rate = float(out_rate)
        self.bank = design_polyphase_bank(self.P, self.Q, taps_per_phase, atten_db)
        self.T = self.bank.shape[1]
        self._bank_rev = jnp.asarray(self.bank[:, ::-1].copy())
        if impl not in ("auto", "conv", "window"):
            raise ValueError(
                f"impl must be 'auto', 'conv' or 'window', got {impl!r}")
        if impl == "auto":
            w_len = (self.Q - 1) + self.T
            impl = "conv" if -(-w_len // self.Q) <= 8 else "window"
        self.impl = impl
        self._taps_mat = (
            jnp.asarray(make_taps_matrix(self.bank, self.P, self.Q))
            if impl == "conv" else None
        )
        self.channels = channels      # None = single stream; int C = batch

        # streaming state: next output index + T−1 input history samples
        # (m_next is shared across channels: the output grid depends only on
        # input counts, which are identical for every channel of a capture)
        self.m_next = 0
        self.in_consumed = 0          # absolute input samples seen
        hist_shape = (self.T - 1,) if channels is None else (channels, self.T - 1)
        self._hist_i = np.zeros(hist_shape, dtype=np.float32)
        self._hist_q = np.zeros(hist_shape, dtype=np.float32)

    # -- plumbing -----------------------------------------------------------

    def out_count_for(self, n_new_inputs: int) -> int:
        """Outputs produced once ``n_new_inputs`` more samples arrive."""
        s1 = self.in_consumed + n_new_inputs
        m_hi = -(-s1 * self.P // self.Q) - 1   # last m with ⌊mQ/P⌋ ≤ s1−1
        return max(0, m_hi + 1 - self.m_next)

    def max_out_for(self, chunk_capacity: int) -> int:
        """Static bound on outputs per chunk (for fixed kernel shapes)."""
        return chunk_capacity * self.P // self.Q + 2

    def process(self, i: np.ndarray, q: np.ndarray, valid: int, M: int):
        """Resample one chunk.

        ``i, q`` : ``(N,)`` — or ``(C, N)`` with ``channels=C`` — planar
                   float32 arrays; entries beyond ``valid`` are padding and
                   never influence valid outputs.
        ``M``    : static output capacity (≥ out_count_for(valid)).
        Returns (yi, yq, n_valid_outputs).

        The host half (:meth:`step_operands`) and the device half
        (:meth:`device_step`) are also called separately by the
        channel-sharded cascade step (``parallel.sharded``).
        """
        a1, a2, n_out = self.step_operands(valid, int(np.shape(i)[-1]), M)
        # History stays a device array: no host sync on the async path.
        yi, yq, self._hist_i, self._hist_q = self.device_step(
            self._hist_i, self._hist_q, i, q,
            jnp.int32(a1), jnp.int32(a2), int(valid), int(M))
        return yi, yq, n_out

    def step_operands(self, valid: int, N: int, M: int):
        """Host half of :meth:`process` for a chunk of ``N`` samples, ``valid``
        of them real: returns ``(a1, a2, n_out)`` — the chunk's two dynamic
        alignment ints ((start0, p0) for 'conv', (rem0, off0) for 'window')
        and its valid output count — and advances the stream counters."""
        T, P, Q = self.T, self.P, self.Q
        n_out = self.out_count_for(valid)
        if int(valid) * P >= (1 << 31) // 2:
            raise ValueError("chunk too large for 32-bit phase arithmetic")
        m0 = self.m_next
        if self.impl == "conv":
            a1, a2, *_ = conv_stream_geometry(
                m0, self.in_consumed, int(M), int(N), P=P, Q=Q, T=T
            )
        else:
            # buffer index 0 holds absolute input index in_consumed − (T−1);
            # off0 is the buffer position of ⌊m0·Q/P⌋ − (T−1)
            a1, a2 = (m0 * Q) % P, (m0 * Q) // P - self.in_consumed
        self.m_next = m0 + n_out
        self.in_consumed += int(valid)
        return a1, a2, n_out

    def device_step(self, hist_i, hist_q, i, q, a1, a2, valid, M: int):
        """Device half of :meth:`process`, pure: reads only the stage's
        static shape and taps, never its stream state.

        ``hist_i/hist_q`` ``(..., T−1)`` history, ``i/q`` ``(..., N)`` chunk,
        ``a1/a2`` from :meth:`step_operands`, ``valid`` (int or traced int32)
        the real input count.  Returns ``(yi, yq, new_hist_i, new_hist_q)``.
        """
        T, P, Q = self.T, self.P, self.Q
        xi = jnp.concatenate([jnp.asarray(hist_i), jnp.asarray(i)], axis=-1)
        xq = jnp.concatenate([jnp.asarray(hist_q), jnp.asarray(q)], axis=-1)
        if self.impl == "conv":
            _, _, K, PADZ, TAIL = conv_stream_geometry(
                0, 0, M, int(np.shape(i)[-1]), P=P, Q=Q, T=T)
            yi, yq = resample_conv_stream(
                xi, xq, self._taps_mat, a1, a2,
                P=P, Q=Q, T=T, K=K, M=M, PADZ=PADZ, TAIL=TAIL,
            )
        else:
            yi, yq = _resample_kernel(xi, xq, self._bank_rev, a1, a2,
                                      P=P, Q=Q, T=T, M=M)
        # The new T−1-sample history is a pure SLICE of the [hist | chunk]
        # buffer (its first T−1+valid elements are exactly
        # [hist | chunk[:valid]]) — no second full-chunk concat.
        hi = jax.lax.dynamic_slice_in_dim(xi, valid, T - 1, axis=-1)
        hq = jax.lax.dynamic_slice_in_dim(xq, valid, T - 1, axis=-1)
        return yi, yq, hi, hq

    # -- checkpointing ------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "m_next": self.m_next,
            "in_consumed": self.in_consumed,
            "hist_i": np.asarray(self._hist_i).copy(),
            "hist_q": np.asarray(self._hist_q).copy(),
        }

    def load_state(self, state: dict) -> None:
        self.m_next = int(state["m_next"])
        self.in_consumed = int(state["in_consumed"])
        self._hist_i = np.asarray(state["hist_i"], dtype=np.float32).copy()
        self._hist_q = np.asarray(state["hist_q"], dtype=np.float32).copy()


def resample_oracle(x: np.ndarray, P: int, Q: int, bank: np.ndarray) -> np.ndarray:
    """NumPy golden model: y[m] = Σ_l bank[(mQ)%P, l] · x[⌊mQ/P⌋ − l].

    Produces every output whose newest input exists; out-of-range (negative)
    taps read zeros, matching the streaming implementation's zero history.
    Evaluated in complex128 over windows gathered in bounded batches, so
    it scores streams of many seconds.
    """
    x = np.asarray(x, dtype=np.complex128)
    bank = np.asarray(bank, dtype=np.float64)
    T = bank.shape[1]
    n_out = (len(x) * P + Q - 1) // Q  # m with floor(mQ/P) <= len(x)-1
    while n_out > 0 and (n_out - 1) * Q // P > len(x) - 1:
        n_out -= 1
    xp = np.concatenate([np.zeros(T - 1, dtype=np.complex128), x])
    back = (T - 1) - np.arange(T)          # x[n − l] sits at xp[n + T−1 − l]
    y = np.zeros(n_out, dtype=np.complex128)
    step = max(1, (1 << 22) // T)
    for lo in range(0, n_out, step):
        m = np.arange(lo, min(n_out, lo + step), dtype=np.int64)
        n, p = (m * Q) // P, (m * Q) % P
        y[lo:lo + m.size] = np.einsum(
            "ml,ml->m", bank[p], xp[n[:, None] + back[None, :]])
    return y


def make_taps_matrix(bank: np.ndarray, P: int, Q: int) -> np.ndarray:
    """Host: fold the polyphase bank into the windows-matmul taps matrix.

    ``taps_mat[j, p] = bank_rev[(pQ) mod P, j − ⌊pQ/P⌋]`` (zero outside the
    tap range): output m = i·P + p is then ``Σ_j x[iQ + j] · taps_mat[j, p]``
    over the strided window row — one matmul for all phases at once.
    """
    T = bank.shape[1]
    bank_rev = bank[:, ::-1]
    w_len = (Q - 1) + T
    taps = np.zeros((w_len, P), dtype=np.float32)
    for p in range(P):
        fp = (p * Q) // P
        taps[fp : fp + T, p] = bank_rev[(p * Q) % P]
    return taps


@partial(jax.jit, static_argnames=("P", "Q", "T"))
def resample_conv_block(xi, xq, taps_mat, *, P: int, Q: int, T: int):
    """Windows + matmul resampler for a chunk at alignment 0.

    Mathematically identical to the gather kernel for window alignment 0:
    ``xi/xq`` are ``(..., H + N)`` with ``H = T−1`` history samples
    prepended and ``N`` a multiple of Q; produces the ``N·P/Q`` outputs with
    absolute output index 0 at logical input 0.

    Output m = i·P + p needs inputs ``x_phys[iQ + j]`` for j < Q−1+T — rows
    of a stride-Q unfold of the input.  The unfold is R+1 shifted reshapes
    (regular memory, no gather, no strided conv lowering), and all P phases
    reduce in a single ``(K, W_len) @ (W_len, P)`` matmul.
    """
    H = T - 1
    N = xi.shape[-1] - H
    if N % Q:
        raise ValueError(f"fast path needs N % Q == 0 (N={N}, Q={Q})")
    K = N // Q
    w_len = (Q - 1) + T
    R = -(-w_len // Q)          # extra rows needed beyond each window's own

    lead = xi.shape[:-1]
    x2 = jnp.stack([xi, xq], axis=-2).reshape(-1, xi.shape[-1])  # (B*·2, H+N)
    pad = (K + R) * Q - x2.shape[-1]
    x2 = jnp.pad(x2, ((0, 0), (0, max(0, pad))))
    G = x2[:, : (K + R) * Q].reshape(-1, K + R, Q)
    # Banded matmul as Σ_r (shifted rows) @ (taps slice): never materializes
    # the (K, w_len) windows tensor — the naive einsum form writes+reads a
    # tensor Q× the input and falls far off the HBM roofline.  R = ⌈w_len/Q⌉
    # slices cover every window row; anything past them is zero padding.
    taps_pad = jnp.pad(taps_mat, ((0, R * Q - w_len), (0, 0)))
    y = None
    for r in range(R):
        term = jax.lax.dot_general(
            G[:, r : r + K, :], taps_pad[r * Q : (r + 1) * Q],
            dimension_numbers=(((2,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )                                                        # (B*·2, K, P)
        y = term if y is None else y + term
    y = y.reshape(*lead, 2, K * P)
    return y[..., 0, :], y[..., 1, :]


def attach_resampler(pipe, out_rate: float, *, stages: str = "single",
                     **kwargs) -> None:
    """CLI glue: give a Pipeline a post-mix resampler stage.

    ``stages``: 'single' (bit-stable default), 'auto' (halfband cascade for
    ≥4× decimation), or 'multi' (force the cascade) — see ops.multistage.
    """
    from doppler_tpu.ops.multistage import make_resampler

    pipe.set_resampler(
        make_resampler(pipe.samplerate, out_rate, stages=stages, **kwargs)
    )
