"""Lane-parallel interleaved rANS for the device (pure jnp encode).

The host rANS (ops.entropy / native/rans.cpp) is 16-way SIMD; this module
is its device counterpart: **hundreds to thousands of independent
rANS lanes advanced in lockstep by one ``lax.scan``** — the entropy stage
the reference runs on the CPU (reference: src/archive.rs:36-38) re-shaped
for a vector machine.  It exists so ``HGICodec.write_fast`` can entropy-
code residuals *on the device*, inside the same jit program as the
encode: only entropy-reduced bytes ever cross the host<->device link.

Design (same constants as the host coder: M = 2**14, u32 states, u16
word renorm, at most one emission per symbol):

* the flat stream is laid out ``sym[t, l] = flat[t * L + l]`` — the
  interleaved assignment balances per-lane entropy almost perfectly, so
  per-lane stream lengths stay within a few words of each other;
* the frequency table is built on device (chunked one-hot histogram +
  a branch-free normalizer) and stored in the payload — any valid table
  decodes, so the normalizer needs no host mirror;
* per-symbol ``freq``/``cum`` are gathered for the WHOLE stream before
  the scan; the scan body is pure u32 arithmetic on [L] vectors;
* emissions (<= 1 u16 per lane per step) land in a [T, L] buffer; ONE
  global ``lax.sort_key_val`` (key = final stream position: lane-major,
  within-lane decode order) compacts every emitted word into the exact
  stored byte order — the only data-dependent move, still fully
  vectorized, and it means a host on a slow link fetches exactly
  ``sum(counts)`` words, zero padding;
* the host finalizer is pure framing: headers + one ``tobytes``.

Encode is plain jnp and runs on any backend.  The decoder
is vectorized NumPy — lanes advance in lockstep, one Python step per
symbol row — fast enough for the read path and trivially auditable.

Payload layout (little-endian):
  u32 n | u32 L | u16 freq[256] | u16 counts[L] | u32 state[L] |
  per lane, counts[l] u16 words in DECODE order, lane-major.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "MAX_SYMBOLS",
    "encode_device",
    "finalize_stream",
    "encode_bytes",
    "decode_bytes",
    "lanes_for",
]

_SCALE_BITS = 14
_M = 1 << _SCALE_BITS
_STATE_L = 1 << 16  # state lower bound; renorm emits one u16
# emit iff state >= freq << 18; compare shifted to dodge u32 overflow
_RENORM_SHIFT = 18

_I32 = jnp.int32
_U16 = jnp.uint16
_U32 = jnp.uint32

# Histogram totals are computed exactly in float32 (counts <= n must be
# exact ints); beyond 2**24 symbols callers chunk or use the host coder.
MAX_SYMBOLS = 1 << 24

_MIN_LANES, _MAX_LANES = 128, 8192


def lanes_for(n: int) -> int:
    """Lane count for an n-symbol stream: ~512 symbols per lane, pow2.

    Few lanes keep the flush overhead (6 B/lane) small on tiny inputs;
    many lanes keep the scan short and the VPU full on big ones.
    """
    target = max(_MIN_LANES, min(_MAX_LANES, n // 512))
    return 1 << (target.bit_length() - 1)


def _histogram(sym: jnp.ndarray) -> jnp.ndarray:
    """Exact [256] i32 histogram of an int32 [T, L] symbol block.

    Chunked one-hot reduction: VPU-friendly (compare + integer sum), no
    scatters.  Chunks of 8 rows bound the one-hot intermediate to
    8 * L * 256 bytes of i1.
    """
    t, l = sym.shape
    chunk = 8
    tp = -(-t // chunk) * chunk
    # Padding symbol 256 falls outside the iota and counts nowhere.
    padded = jnp.pad(sym, ((0, tp - t), (0, 0)), constant_values=256)
    blocks = padded.reshape(tp // chunk, chunk, l)
    iota = jnp.arange(256, dtype=_I32)

    def step(acc, rows):
        return acc + (rows[..., None] == iota).sum((0, 1), dtype=_I32), None

    counts, _ = lax.scan(step, jnp.zeros(256, _I32), blocks, unroll=4)
    return counts


def _normalize_device(counts: jnp.ndarray) -> jnp.ndarray:
    """Quantize [256] counts to a table summing to exactly M = 2**14.

    Every present symbol gets freq >= 1.  Unlike ops.entropy.
    normalized_freqs this does NOT need to match any other backend
    bit-for-bit: the table is stored in the payload, so any valid table
    decodes — which is what makes a branch-free device version possible.
    """
    total = counts.sum()
    present = counts > 0
    # counts <= MAX_SYMBOLS are exact in f32; floor() may still land one
    # off the exact quotient, which only moves a unit of drift — handled
    # below like any other rounding.
    scaled = jnp.floor(
        counts.astype(jnp.float32) * np.float32(_M) / total.astype(jnp.float32)
    ).astype(_I32)
    freq = jnp.where(present, jnp.clip(scaled, 1, _M - 1), 0)
    drift = _M - freq.sum()

    # Absorb as much drift as fits into the most frequent symbol.
    iota = jnp.arange(256, dtype=_I32)
    mx = jnp.argmax(counts).astype(_I32)
    fmx = jnp.take(freq, mx)
    give = jnp.clip(drift, -(fmx - 1), (_M - 1) - fmx)
    freq = freq + jnp.where(iota == mx, give, 0)
    drift = drift - give

    # Residual drift (|drift| < 256 after the absorb): +-1 units spread
    # in index order.  Positive drift may raise absent symbols to 1 (a
    # wasted slot, never a correctness issue); negative never drops a
    # present symbol below 1.  Six rounds cover every reachable case
    # (each round moves min(|drift|, #eligible) and eligible >= 255 for
    # positive drift, >= |drift|/6 for negative by construction).
    for _ in range(6):
        pos = drift > 0
        eligible = jnp.where(pos, freq < (_M - 1), freq > 1)
        rank = jnp.cumsum(eligible.astype(_I32))
        delta = (eligible & (rank <= jnp.abs(drift))).astype(_I32)
        signed = jnp.where(pos, delta, -delta)
        freq = freq + signed
        drift = drift - signed.sum()
    return freq


def _lookup_packed(sym: jnp.ndarray, packed: jnp.ndarray) -> jnp.ndarray:
    """``packed[sym]`` for a [T, L] i32 symbol block, without gathers.

    This nibble-split one-hot selection is pure compare/select/sum
    arithmetic (32 fused ops per element) in place of a gather of
    millions of indices; whether a real gather is faster on the GPU is
    not measured.  ``packed`` is any i32[256] table (values must fit
    i32).
    """
    tbl = packed.reshape(16, 16)
    lo = sym & 15
    hi = sym >> 4
    iota16 = jnp.arange(16, dtype=_I32)
    # partial[..., h] = tbl[h, lo[...]]
    oh_lo = lo[..., None, None] == iota16  # [T, L, 1, 16]
    partial = jnp.where(oh_lo, tbl, 0).sum(-1)  # [T, L, 16]
    return jnp.where(hi[..., None] == iota16, partial, 0).sum(-1)


def encode_device(flat: jnp.ndarray):
    """Device rANS encode of a flat uint8 [n] stream (jit-composable).

    Returns ``(freq [256] i32, counts [L] i32, states [L] u32,
    stream [T, L] u16)`` where ``stream.ravel()[:counts.sum()]`` is the
    payload's word stream in its final stored order (garbage beyond).
    ``n`` must be a static shape <= :data:`MAX_SYMBOLS`.

    Measured negative result (r5): compacting per-LANE instead (sort
    along T only — ~5x cheaper on device, 846 vs 495 MB/s stage — with
    the dense lane-major packing moved to the host) makes the prefix
    FETCH size the max lane count instead of the mean; on structured
    content the lanes imbalance >2x (the interleaved assignment
    resonates with the image width), ballooning write_fast's transfer
    934 KB -> 2.1 MB and REGRESSING the link-normalized e2e 150 -> 87
    MPix/s at a 100 MB/s link.  write_fast exists for slow links, so
    the dense global sort stays.
    """
    n = int(flat.shape[0])
    if n == 0:
        raise ValueError("empty stream")
    if n > MAX_SYMBOLS:
        raise ValueError(f"stream of {n} symbols exceeds {MAX_SYMBOLS}")
    L = lanes_for(n)
    T = -(-n // L)
    sym = jnp.pad(flat.astype(_I32), (0, T * L - n)).reshape(T, L)

    freq = _normalize_device(_histogram(sym))
    cum = jnp.cumsum(freq) - freq  # exclusive

    # Whole-stream table lookups before the scan: the scan body is pure
    # elementwise u32 arithmetic.  freq and cum ride one packed i32 table
    # (freq <= 2**14 in bits 16.., cum < 2**14 in bits ..14) so the
    # lookup pass runs once.
    fc = _lookup_packed(sym, (freq << 16) | cum)
    fs = (fc >> 16).astype(_U32)
    cs = (fc & 0xFFFF).astype(_U32)

    # rANS is LIFO: encode symbol rows last-to-first so decode runs
    # first-to-last.  Scan step t processes symbol row T-1-t.
    fs_r, cs_r = fs[::-1], cs[::-1]

    def step(x, fc):
        f, c = fc
        emit = (x >> _U32(_RENORM_SHIFT)) >= f
        word = (x & _U32(0xFFFF)).astype(_U16)
        x = jnp.where(emit, x >> _U32(16), x)
        q = x // f
        x = (q << _U32(_SCALE_BITS)) + (x - q * f) + c
        return x, (word, emit)

    x0 = jnp.full((L,), _STATE_L, _U32)
    # unroll: the per-step body is two vregs of elementwise work, so the
    # T (~1000-row) scan is loop-overhead-bound; unrolling batches 8
    # symbol rows per loop iteration with IDENTICAL outputs (pure jax
    # scan semantics — the stream bytes cannot change).
    states, (words, emits) = lax.scan(step, x0, (fs_r, cs_r), unroll=8)

    counts = emits.sum(0, dtype=_I32)
    # Global compaction straight into the STORED byte order: lane-major,
    # within each lane the reverse of emission order (= decode order).
    # One sort; the compacted words occupy stream[:sum(counts)] exactly,
    # so a prefix fetch transfers zero padding.  Emitted keys are
    # unique, so an unstable sort is byte-safe and skips the stability
    # passes (stage 356 -> 495 MB/s measured).  See the docstring for
    # why the cheaper per-lane sort was rejected.
    t_iota = lax.broadcasted_iota(_I32, (T, L), 0)
    l_iota = lax.broadcasted_iota(_I32, (T, L), 1)
    key = jnp.where(emits, l_iota * T + (T - 1 - t_iota), T * L)
    _, stream = lax.sort_key_val(
        key.reshape(-1), words.reshape(-1), is_stable=False
    )
    return freq, counts, states, stream.reshape(T, L)


def meta_rows_for(L: int) -> int:
    """Header rows of the packed single-buffer layout (encode_device_packed)."""
    return 3 + -(-256 // L)


def encode_device_packed(flat: jnp.ndarray) -> jnp.ndarray:
    """:func:`encode_device` packed into ONE u16 [meta + T, L] buffer.

    Row 0: per-lane word counts; rows 1-2: final states (lo16, hi16);
    next ceil(256/L) rows: the freq table; remaining T rows: the
    compacted word stream (final stored order).  One buffer means a host
    on a high-latency link pulls everything with a SINGLE prefix fetch
    sized by a cached estimate (write_fast), instead of paying one round
    trip for the counts and another for the body.
    """
    freq, counts, states, stream = encode_device(flat)
    L = stream.shape[1]
    frows = -(-256 // L)
    ftab = jnp.pad(freq, (0, frows * L - 256)).reshape(frows, L)
    head = jnp.stack(
        [
            counts.astype(_U16),
            (states & _U32(0xFFFF)).astype(_U16),
            (states >> _U32(16)).astype(_U16),
        ]
    )
    return jnp.concatenate([head, ftab.astype(_U16), stream], axis=0)


def unpack_meta(head: np.ndarray, L: int):
    """Invert the packed header rows -> (freq, counts, states) NumPy."""
    head = np.asarray(head)
    counts = head[0].astype(np.int64)
    states = head[1].astype(np.uint32) | (head[2].astype(np.uint32) << 16)
    frows = -(-256 // L)
    freq = head[3 : 3 + frows].reshape(-1)[:256].astype(np.int64)
    return freq, counts, states


def finalize_stream(
    n: int,
    freq: np.ndarray,
    counts: np.ndarray,
    states: np.ndarray,
    stream: np.ndarray,
) -> bytes:
    """Frame device outputs into the payload (host; pure framing).

    ``stream`` is the device's compacted word buffer (or any flattened
    prefix of it covering ``counts.sum()`` words) — already in stored
    order, so the finalizer is headers + one ``tobytes``.
    """
    freq = np.asarray(freq)
    counts = np.asarray(counts, dtype=np.int64)
    states = np.asarray(states, dtype=np.uint32)
    words = np.asarray(stream, dtype=np.uint16).reshape(-1)
    total = int(counts.sum())
    if words.shape[0] < total:
        raise ValueError("stream prefix shorter than the word count")
    return b"".join(
        (
            int(n).to_bytes(4, "little"),
            int(counts.shape[0]).to_bytes(4, "little"),
            freq.astype("<u2").tobytes(),
            counts.astype("<u2").tobytes(),
            states.astype("<u4").tobytes(),
            words[:total].astype("<u2").tobytes(),
        )
    )


def encode_bytes(data: bytes) -> bytes:
    """Convenience end-to-end encode (device compute + host framing).

    Fetches only the compacted word prefix (the payload itself), not the
    full fixed-capacity stream buffer — on a slow host<->device link the
    transfer is the coded bytes plus one counts round trip.
    """
    flat = jnp.asarray(np.frombuffer(data, np.uint8))
    if flat.shape[0] == 0:
        return (0).to_bytes(4, "little") + (0).to_bytes(4, "little")
    freq, counts, states, stream = jax.jit(encode_device)(flat)
    freq_np, counts_np, states_np = jax.device_get((freq, counts, states))
    L = counts_np.shape[0]
    rows = min(int(stream.shape[0]), -(-int(counts_np.sum()) // L))
    return finalize_stream(
        len(data), freq_np, counts_np, states_np, np.asarray(stream[:rows])
    )


def decode_bytes(data: bytes, expected_n: int = None) -> np.ndarray:
    """Decode a payload back to uint8 [n] (host-only).

    Prefers the native C++ decoder (native/tpu_rans.cpp); the vectorized
    NumPy body below is the portable mirror — bit-identical output and
    accept/reject behavior (tests/test_tpurans.py cross-validates).
    ``expected_n`` (when given) must match the embedded size exactly —
    the container's bomb guard: a hostile payload cannot declare its own
    allocation.  Raises ``ValueError`` on any malformed input.
    """
    if len(data) < 8:
        raise ValueError("truncated rans_tpu stream")
    try:
        from .native import available, native_rans_tpu_decode

        if available():
            size = (
                expected_n
                if expected_n is not None
                else int.from_bytes(data[0:4], "little")
            )
            return native_rans_tpu_decode(data, size)
    except RuntimeError:
        pass
    n = int.from_bytes(data[0:4], "little")
    L = int.from_bytes(data[4:8], "little")
    if expected_n is not None and n != expected_n:
        raise ValueError(
            f"rans_tpu stream size {n} does not match declared {expected_n}"
        )
    if n == 0:
        if L != 0:
            raise ValueError("empty stream with nonzero lane count")
        return np.zeros(0, np.uint8)
    if not (_MIN_LANES <= L <= _MAX_LANES) or L & (L - 1):
        raise ValueError(f"invalid rans_tpu lane count {L}")
    T = -(-n // L)
    hdr = 8 + 512 + 2 * L + 4 * L
    if len(data) < hdr:
        raise ValueError("truncated rans_tpu stream")
    freq = np.frombuffer(data, "<u2", count=256, offset=8).astype(np.int64)
    if int(freq.sum()) != _M:
        raise ValueError("invalid rans_tpu frequency table")
    counts = np.frombuffer(data, "<u2", count=L, offset=8 + 512).astype(
        np.int64
    )
    if counts.max(initial=0) > T:
        raise ValueError("rans_tpu lane count exceeds symbol rows")
    states = np.frombuffer(
        data, "<u4", count=L, offset=8 + 512 + 2 * L
    ).astype(np.int64)
    total = int(counts.sum())
    if len(data) < hdr + 2 * total:
        raise ValueError("truncated rans_tpu stream body")
    stream = np.frombuffer(data, "<u2", count=total, offset=hdr).astype(
        np.int64
    )

    cum = np.concatenate(([0], np.cumsum(freq)))
    slot2sym = np.repeat(np.arange(256, dtype=np.uint8), freq)

    starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    ends = starts + counts
    ptr = starts.copy()
    x = states
    out = np.empty((T, L), np.uint8)
    mask = _M - 1
    guard = max(total - 1, 0)
    for t in range(T):
        slot = x & mask
        s = slot2sym[slot]
        out[t] = s
        s64 = s.astype(np.int64)
        x = freq[s64] * (x >> _SCALE_BITS) + slot - cum[s64]
        need = x < _STATE_L
        if total:
            idx = np.minimum(ptr, guard)
            x = np.where(need, (x << 16) | stream[idx], x)
        elif need.any():
            raise ValueError("rans_tpu stream underrun")
        ptr = ptr + need
    if (ptr != ends).any():
        raise ValueError("rans_tpu stream underrun or trailing words")
    # Every lane must unwind exactly to the encoder's initial state — a
    # whole-stream integrity check that costs one compare.
    if (x != _STATE_L).any():
        raise ValueError("rans_tpu state mismatch (corrupt stream)")
    return out.reshape(-1)[:n]
