"""Device k-mer extraction kernels.

The reference extracts k-mers with a sequential rolling 2-bit encoder
(kmer/src/kmer.rs:80-106: shift-in one base per step, ambiguous bases
reset the window). On the device we instead express every k-mer as an
independent weighted sum over a static window of base codes, so the
whole read batch becomes k shifted vector ops the XLA compiler fuses —
no sequential state, no data-dependent control flow:

    fwd[i]  =  sum_j codes[i+j] * 4^(k-1-j)         (Horner, k slices)
    rc[i]   =  sum_j (3 - codes[i+j]) * 4^j
    valid[i] = no ambiguous base in codes[i:i+k] and i+k <= row length

Two representations:
  * k <= 15: single int32 (2k <= 30 bits)
  * k <= 31: (hi, lo) uint32 pair — hi = first k-16 bases, lo = last 16.
    Because each half is its own weighted sum there is never a carry
    between the halves, and no 64-bit integer op is needed.

Ambiguity semantics match the reference: a k-mer is valid iff all k of
its bases are unambiguous (equivalent to the reset-on-N rule of
kmer.rs:96-99).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def unpack_planes(packed: jnp.ndarray, validbits: jnp.ndarray) -> jnp.ndarray:
    """(R, W/4) u8 2-bit-packed bases + (R, W/8) u8 validity bitmap ->
    (R, W) u8 codes with 4 at invalid/padding positions.

    Host->device transfer feeds every device step (SURVEY.md §7 "host
    feed rate"); packing base codes 4-per-byte plus
    a 1-bit valid plane cuts upload bytes ~3.6x. The unpack is a few
    fused elementwise shifts on device — effectively free next to the
    transfer it saves.
    """
    R, Wq = packed.shape
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2  # base j in bits 2j..2j+1
    codes = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint8(3)
    codes = codes.reshape(R, Wq * 4)
    bshifts = jnp.arange(8, dtype=jnp.uint8)
    vbits = (validbits[:, :, None] >> bshifts[None, None, :]) & jnp.uint8(1)
    valid = vbits.reshape(R, validbits.shape[1] * 8)[:, : Wq * 4]
    return jnp.where(valid == 1, codes, jnp.uint8(4))


@jax.jit
def unpack_packed(packed: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """(R, W/4) u8 2-bit-packed bases + (R,) i32 row lengths ->
    (R, W) u8 codes with 4 at padding positions.

    The ambiguity-free fast path: when the host packer found no
    ambiguous base inside any row (pack_planes n_ambig == 0), validity
    is fully implied by the row length, so the 1-bit valid plane never
    crosses the wire — upload is exactly 2 bits/base, the entropy floor
    for random DNA. io/batch.py:pack_planes decides per batch.
    """
    R, Wq = packed.shape
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    codes = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint8(3)
    codes = codes.reshape(R, Wq * 4)
    pos = jax.lax.broadcasted_iota(jnp.int32, (R, Wq * 4), 1)
    return jnp.where(pos < lengths[:, None], codes, jnp.uint8(4))


def _valid_windows(codes: jnp.ndarray, k: int) -> jnp.ndarray:
    """(R, W) codes -> (R, W-k+1) bool: window of k unambiguous bases.

    Padding/ambiguous bases are code 4, so row length is implied.
    """
    bad = (codes >= 4).astype(jnp.int32)
    inv = jnp.cumsum(bad, axis=1)
    zeros = jnp.zeros((codes.shape[0], 1), dtype=jnp.int32)
    inv0 = jnp.concatenate([zeros, inv], axis=1)  # (R, W+1)
    P = codes.shape[1] - k + 1
    return (inv0[:, k : k + P] - inv0[:, :P]) == 0


@functools.partial(jax.jit, static_argnames=("k",))
def kmer_ids_small(codes: jnp.ndarray, k: int):
    """k <= 15 path. Returns (fwd, rc, valid), int32 (R, W-k+1)."""
    assert 1 <= k <= 15
    c = codes.astype(jnp.int32)
    P = codes.shape[1] - k + 1
    fwd = jnp.zeros((codes.shape[0], P), dtype=jnp.int32)
    for j in range(k):
        fwd = fwd * 4 + c[:, j : j + P]
    rc = jnp.zeros_like(fwd)
    for j in range(k - 1, -1, -1):
        rc = rc * 4 + (3 - c[:, j : j + P])
    valid = _valid_windows(codes, k)
    return fwd, rc, valid


@functools.partial(jax.jit, static_argnames=("k",))
def canonical_ids_small(codes: jnp.ndarray, k: int):
    """min(fwd, rc) canonical ids, zeroed where invalid."""
    fwd, rc, valid = kmer_ids_small(codes, k)
    canon = jnp.minimum(fwd, rc)
    return jnp.where(valid, canon, 0), valid


@functools.partial(jax.jit, static_argnames=("k",))
def kmer_ids_pair(codes: jnp.ndarray, k: int):
    """k <= 31 path. Returns (fwd_hi, fwd_lo, rc_hi, rc_lo, valid).

    hi/lo are uint32; hi holds the first max(0, k-16) bases, lo the
    remaining min(k, 16). Lexicographic (hi, lo) order == numeric u64
    order of the packed k-mer.
    """
    assert 1 <= k <= 31
    nhi = max(0, k - 16)
    c = codes.astype(jnp.uint32)
    P = codes.shape[1] - k + 1
    zeros = jnp.zeros((codes.shape[0], P), dtype=jnp.uint32)
    fh = zeros
    for j in range(nhi):
        fh = fh * 4 + c[:, j : j + P]
    fl = zeros
    for j in range(nhi, k):
        fl = fl * 4 + c[:, j : j + P]
    three = jnp.uint32(3)
    rh = zeros
    for j in range(nhi):
        rh = rh * 4 + (three - c[:, k - 1 - j : k - 1 - j + P])
    rl = zeros
    nlo = k - nhi
    for j in range(nlo):
        rl = rl * 4 + (three - c[:, nlo - 1 - j : nlo - 1 - j + P])
    valid = _valid_windows(codes, k)
    return fh, fl, rh, rl, valid


@functools.partial(jax.jit, static_argnames=("k",))
def canonical_ids_pair(codes: jnp.ndarray, k: int):
    """Canonical (hi, lo) pair; invalid positions get the all-ones
    sentinel so they sort to the end of any multi-key sort."""
    fh, fl, rh, rl, valid = kmer_ids_pair(codes, k)
    use_fwd = (fh < rh) | ((fh == rh) & (fl <= rl))
    hi = jnp.where(use_fwd, fh, rh)
    lo = jnp.where(use_fwd, fl, rl)
    sent = jnp.uint32(0xFFFFFFFF)
    hi = jnp.where(valid, hi, sent)
    lo = jnp.where(valid, lo, sent)
    return hi, lo, valid
