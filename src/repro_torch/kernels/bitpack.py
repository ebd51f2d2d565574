"""Bit-packed cluster-state layout and packed PAC math (port of
``repro/kernels/bitpack.py``, availability half).

The node axis of a boolean rank-space tile is packed into 32-bit words
(n=155 -> five words per lane): bit b of word k is succession rank
32k+b, and the padding bits of the top word are zero.  The reference
carries the words as uint32; torch has no ``>>`` or ``+`` for uint32 on
the CPU, so the port carries the same bit patterns in int32 (a word with
bit 31 set reads as negative) and does its arithmetic in int64 on values
in [0, 2^32), masking back to 32 bits where a product can overflow.
``to_u32`` / ``to_i32`` convert between the two carriers.

``pac_eval_packed`` is the plain PyTorch version of the ``fused_pac_eval``
kernel (kernels/fused_step.py) and follows the reference function step
for step: SWAR popcount, prefix masks, k rounds of lowest-set-bit
extraction.  All of it is integer and bit math, so it is exact.  The
downtime half (``downtime_eval_packed``, ``select_bit``) belongs to the
§6 slice (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import torch

WORD_BITS = 32

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_H01 = 0x01010101
_MASK32 = 0xFFFFFFFF


def n_words(n_bits: int) -> int:
    """Words needed to hold n_bits lanes (ceil division)."""
    return -(-n_bits // WORD_BITS)


def to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32-carried words -> int64 values in [0, 2^32) (same bits)."""
    return words.to(torch.int64) & _MASK32


def to_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same bit pattern
    (bit 31 set reads as negative).  Subtracts 2^32 explicitly rather
    than relying on a narrowing cast to wrap."""
    return (values - ((values & 0x80000000) << 1)).to(torch.int32)


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words (int32- or int64-carried) -> int32
    counts, the reference's three masked shift-adds and multiply-shift."""
    v = to_u32(v)
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return (((v * _H01) & _MASK32) >> 24).to(torch.int32)


def prefix_masks(count: int, n_bits: int):
    """Per-word masks selecting the first `count` of n_bits lanes, as a
    tuple of python ints in [0, 2^32)."""
    W = n_words(n_bits)
    full, rem = divmod(min(count, n_bits), WORD_BITS)
    masks = [_MASK32] * full + [0] * (W - full)
    if full < W and rem:
        masks[full] = (1 << rem) - 1
    return tuple(masks)


def pack_words(bools: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., W) int32 words, bit b of word k = lane 32k+b.

    Accumulates in int64 (a word with bit 31 set does not fit a
    non-negative int32) and converts to the int32 bit pattern at the end.
    """
    n = bools.shape[-1]
    W = n_words(n)
    pad = W * WORD_BITS - n
    b = bools.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(b.shape[:-1] + (W, WORD_BITS))
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=b.device)
    return to_i32(torch.sum(b << shifts, dim=-1))


def unpack_words(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., n_bits) bool — pack_words' inverse."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=words.device)
    bits = (to_u32(words)[..., None] >> shifts) & 1
    flat = bits.reshape(bits.shape[:-2] + (-1,))
    return flat[..., :n_bits] != 0


def _mask_planes(planes, masks):
    return [w & m for w, m in zip(planes, masks)]


def _popcount_sum(planes):
    total = popcount32(planes[0])
    for w in planes[1:]:
        total = total + popcount32(w)
    return total


def _any_bit(planes):
    acc = planes[0]
    for w in planes[1:]:
        acc = acc | w
    return acc != 0


def lowest_set_bits(planes, k: int):
    """Keep the k lowest set bits across a word-plane list (lane order) —
    the packed ``up & (cumsum(up) <= rf)``.  Planes are int64 values in
    [0, 2^32); k rounds of lowest-set-bit extraction (lsb = v & -v, clear
    via v & (v - 1)), each taking from the first non-empty word."""
    v = list(planes)
    taken = [torch.zeros_like(w) for w in v]
    for _ in range(k):
        done = None
        for i, w in enumerate(v):
            nz = w != 0
            pick = nz if done is None else (nz & ~done)
            lsb = w & -w
            taken[i] = torch.where(pick, taken[i] | lsb, taken[i])
            v[i] = torch.where(pick, w & (w - 1), w)
            done = nz if done is None else (done | nz)
    return taken


def pac_eval_packed(up_words, full_words, *, rf: int, voters: int,
                    n_real: int):
    """Packed-word PAC, bit-identical to the boolean PAC.

    up_words/full_words: length-W lists of identically-shaped int32 word
    planes (word k, bit b = succession rank 32k+b).  Lanes >= n_real are
    masked by prefix masks.  Returns (lark, maj, creps_words): lark/maj
    bool of the plane shape, creps_words a length-W list of int32 planes.
    """
    W = len(up_words)
    n_pad = W * WORD_BITS
    real = prefix_masks(n_real, n_pad)
    u = _mask_planes([to_u32(w) for w in up_words], real)
    f = _mask_planes([to_u32(w) for w in full_words], real)
    n_up = _popcount_sum(u)
    majority = 2 * n_up > n_real
    any_roster = _any_bit(_mask_planes(u, prefix_masks(rf, n_pad)))
    full_up = _any_bit([a & b for a, b in zip(u, f)])
    lark = majority & any_roster & full_up
    nv = _popcount_sum(_mask_planes(u, prefix_masks(voters, n_pad)))
    maj = 2 * nv > voters
    creps = [to_i32(w) for w in lowest_set_bits(u, rf)]
    return lark, maj, creps
