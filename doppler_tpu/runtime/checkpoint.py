"""Checkpoint / resume — "resume = seek" made concrete.

The reference has no checkpointing (SURVEY §5): its entire mutable state is
three integers.  This framework makes that state explicit and serializable:

- the NCO counter + absolute stream offset (``ops.phase_plan.NCOState``),
- the scheduler's staircase state (track mode: sample_count/dt/last_time),
- the resampler's next-output index and T−1-sample FIR history,
- stream byte offsets for seeking the input.

``save``/``restore`` round-trip a running :class:`~doppler_tpu.runtime.
pipeline.Pipeline`; restarting at block k of a recorded stream reproduces the
uninterrupted output bitwise (tests/test_checkpoint.py).  The format is a
single ``.npz`` — trivially portable across hosts for elastic recovery.
"""

from __future__ import annotations

import json
import os

import numpy as np

from doppler_tpu.ops.phase_plan import NCOState

__all__ = ["save", "restore", "save_channels", "restore_channels"]

_VERSION = 1


def _savez_exact(path, arrays: dict) -> None:
    """np.savez at the EXACT path: given a filename, np.savez silently
    appends '.npz' unless it already ends with it, which breaks per-host
    suffixed paths like ``ck.npz.h0`` — write through a file object
    instead.  File-like objects pass straight through."""
    if isinstance(path, (str, bytes, os.PathLike)):
        with open(path, "wb") as f:
            np.savez(f, **arrays)
    else:
        np.savez(path, **arrays)


def _scheduler_state(s) -> dict:
    out = {}
    for key in ("sample_count", "dt", "last_time"):
        if hasattr(s, key):
            out[key] = getattr(s, key)
    return out


def _scheduler_sig(s) -> dict:
    """Identity of the DSP configuration the counters belong to.

    Round-5 review find: restore() validated samplerate/dtypes but not the
    shift/mode/track parameters, so resuming a ``--shift -15000``
    checkpoint with ``--shift +3000`` silently produced output matching no
    uninterrupted run.  The signature pins what the counters MEAN.
    """
    sig: dict = {"kind": type(s).__name__}
    for key in ("shift_hz", "frequency_hz", "offset_hz", "start_time"):
        if hasattr(s, key):
            sig[key] = float(getattr(s, key))
    tle = getattr(getattr(s, "predictor", None), "tle", None)
    if tle is not None:
        sig["tlename"] = getattr(tle, "name", None)
    return sig


def _resampler_sig(rs):
    """(P, Q, T) per stage — pins the --resample-to/stages configuration."""
    if rs is None:
        return None
    stages = getattr(rs, "stages", None)
    if stages is not None:
        return [[st.P, st.Q, st.T] for st in stages]
    return [[rs.P, rs.Q, rs.T]]


def _check_sig(meta: dict, key: str, current, what: str) -> None:
    if key in meta and meta[key] != current:
        raise ValueError(
            f"checkpoint {what} {meta[key]!r} does not match the "
            f"pipeline's {current!r} — resuming with a different "
            "configuration would produce output matching no "
            "uninterrupted run")


def _load_scheduler_state(s, state: dict) -> None:
    for key, val in state.items():
        if hasattr(s, key):
            setattr(s, key, type(getattr(s, key))(val))


def save(path: str, pipe) -> None:
    """Snapshot a Pipeline's resumable state to ``path`` (.npz)."""
    meta = {
        "version": _VERSION,
        "samplerate": pipe.samplerate,
        "intype": pipe.intype,
        "outtype": pipe.outtype,
        "block_bytes": pipe.block_bytes,
        "nco_samplenum": pipe.nco_state.samplenum,
        "nco_abs_offset": pipe.nco_state.abs_offset,
        "sample_offset": pipe._sample_offset,
        "scheduler": _scheduler_state(pipe.scheduler),
        "scheduler_sig": _scheduler_sig(pipe.scheduler),
        "has_resampler": pipe.resampler is not None,
        "resampler_sig": _resampler_sig(pipe.resampler),
        # True when the checkpointed run reached EOF and flushed the FIR
        # tail: a restart must not run (and drain) again, or the duplicate
        # tail bytes get appended to the part file (ADVICE r4)
        "drained": bool(getattr(pipe, "_drained", False)),
    }
    arrays = {"meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)}
    if pipe.resampler is not None:
        # generic over state_dict keys so single- and multi-stage resamplers
        # (ops.multistage) both round-trip; integers become 0-d arrays
        for key, val in pipe.resampler.state_dict().items():
            arrays[f"rs_{key}"] = np.asarray(val)
    _savez_exact(path, arrays)


def restore(path: str, pipe) -> dict:
    """Load a snapshot into a compatibly-configured Pipeline.

    Returns the metadata dict (including ``sample_offset`` — the absolute
    input sample at which the caller should resume feeding the stream).
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["version"] != _VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        for key in ("samplerate", "intype", "outtype", "block_bytes"):
            if meta[key] != getattr(pipe, key):
                raise ValueError(
                    f"checkpoint {key}={meta[key]!r} does not match "
                    f"pipeline {getattr(pipe, key)!r}"
                )
        _check_sig(meta, "scheduler_sig", _scheduler_sig(pipe.scheduler),
                   "scheduler config")
        if meta.get("resampler_sig") is not None:
            # (a resampler-less checkpoint restoring into a pipeline with a
            # FRESH resampler stays allowed — the long-standing attach-
            # after-checkpoint pattern; a recorded resampler must match)
            _check_sig(meta, "resampler_sig", _resampler_sig(pipe.resampler),
                       "resampler config")
        pipe.nco_state = NCOState(
            samplenum=int(meta["nco_samplenum"]),
            abs_offset=int(meta["nco_abs_offset"]),
        )
        pipe._sample_offset = int(meta["sample_offset"])
        _load_scheduler_state(pipe.scheduler, meta["scheduler"])
        if meta["has_resampler"]:
            if pipe.resampler is None:
                raise ValueError("checkpoint has resampler state but pipeline has none")
            rstate = {
                name[len("rs_"):]: z[name]
                for name in z.files if name.startswith("rs_")
            }
            pipe.resampler.load_state(rstate)
    return meta


def save_channels(path: str, mpipe) -> None:
    """Snapshot a MultiChannelPipeline (channels mode, SURVEY §5 A4).

    Per-channel state: the NCO counter pair and the scheduler staircase.
    Per rate-group: the batched resampler's (m_next, in_consumed, FIR
    histories).  The sharded and unsharded paths keep the same per-stage
    histories, which is what makes them checkpoint-interoperable.
    """
    meta = {
        "version": _VERSION,
        "kind": "channels",
        "samplerate": mpipe.samplerate,
        "intype": mpipe.intype,
        "outtype": mpipe.outtype,
        "block_bytes": mpipe.block_bytes,
        "samples_in": mpipe.samples_in,
        "channels": [
            {
                "name": ch.name,
                "nco_samplenum": ch.state.samplenum,
                "nco_abs_offset": ch.state.abs_offset,
                "scheduler": _scheduler_state(ch.scheduler),
                "scheduler_sig": _scheduler_sig(ch.scheduler),
                "center_offset_hz": float(ch.center_offset_hz),
            }
            for ch in mpipe.channels
        ],
        "groups": [list(idxs) for idxs, _ in mpipe._groups],
        "group_sigs": [_resampler_sig(rs) for _, rs in mpipe._groups],
        # True when the run reached EOF and flushed the per-channel FIR
        # tails — a restart must not run (and drain) again (ADVICE r4;
        # the channels analog of the stream checkpoint's flag)
        "drained": bool(getattr(mpipe, "_drained", False)),
    }
    arrays = {"meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)}
    for g, (idxs, rs) in enumerate(mpipe._groups):
        if rs is None:
            continue
        for key, val in rs.state_dict().items():
            arrays[f"g{g}_{key}"] = np.asarray(val)
    _savez_exact(path, arrays)


def restore_channels(path: str, mpipe) -> dict:
    """Load a channels-mode snapshot into a compatibly-configured pipeline.

    Returns the metadata dict (``samples_in`` is the absolute input sample
    at which the caller should resume feeding the wideband stream).
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["version"] != _VERSION or meta.get("kind") != "channels":
            raise ValueError("not a channels-mode checkpoint")
        for key in ("samplerate", "intype", "outtype", "block_bytes"):
            if meta[key] != getattr(mpipe, key):
                raise ValueError(
                    f"checkpoint {key}={meta[key]!r} does not match "
                    f"pipeline {getattr(mpipe, key)!r}"
                )
        names_ckpt = [c["name"] for c in meta["channels"]]
        names_pipe = [ch.name for ch in mpipe.channels]
        if names_ckpt != names_pipe:
            raise ValueError(
                f"channel set changed: checkpoint {names_ckpt} vs "
                f"config {names_pipe}"
            )
        if meta["groups"] != [list(idxs) for idxs, _ in mpipe._groups]:
            raise ValueError("rate grouping changed since checkpoint")
        if "group_sigs" in meta:
            cur = [_resampler_sig(rs) for _, rs in mpipe._groups]
            if meta["group_sigs"] != cur:
                raise ValueError(
                    "resampler configuration changed since checkpoint "
                    f"({meta['group_sigs']!r} vs {cur!r})")
        for ch, st in zip(mpipe.channels, meta["channels"]):
            _check_sig(st, "scheduler_sig", _scheduler_sig(ch.scheduler),
                       f"channel {ch.name!r} scheduler config")
            if ("center_offset_hz" in st
                    and st["center_offset_hz"] != float(ch.center_offset_hz)):
                raise ValueError(
                    f"channel {ch.name!r} center offset changed since "
                    "checkpoint")
            ch.state.samplenum = int(st["nco_samplenum"])
            ch.state.abs_offset = int(st["nco_abs_offset"])
            _load_scheduler_state(ch.scheduler, st["scheduler"])
        mpipe.samples_in = int(meta["samples_in"])
        for g, (idxs, rs) in enumerate(mpipe._groups):
            prefix = f"g{g}_"
            rstate = {
                name[len(prefix):]: z[name]
                for name in z.files if name.startswith(prefix)
            }
            if rs is None:
                if rstate:
                    raise ValueError(f"checkpoint group {g} has resampler "
                                     "state but pipeline group has none")
                continue
            if not rstate:
                raise ValueError(f"checkpoint group {g} missing resampler state")
            rs.load_state(rstate)
    return meta
