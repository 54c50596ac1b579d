"""Vectorized canonical k-mer window computation.

The reference rolls one k-mer per base in a scalar loop
(ref: core util/CGATLongBuffer.java:131-216, match/FastqKMerMatcher.java:345-363).
On the device we compute all windows of a (batch of) sequence(s) at once: the
straight and reverse-complement encodings of every window are sums of k
shifted slices of the 2-bit code array — k vector ops instead of a scalar
rolling loop, elementwise-parallel and with no sequential dependence.

A window's k-mer participates iff the window contains no non-CGAT base; this is
exactly the reference's semantics, where scanning skips over bad bases and
counts every window covering a bad base as INVALID
(ref: match/FastqKMerMatcher.java:345-363,415-417).

Device representation: 62-bit k-mers as (hi, lo) uint32 pairs — 32-bit lanes
only, so global x64 stays off. The split boundary is clean because every base
contributes 2 bits at an even shift. Host/golden code uses plain uint64.
Whether scoped uint64 keys would serve the GPU better is ROADMAP C7.
"""

import jax
import jax.numpy as jnp
import numpy as np

from genestrip_tpu.utils.dna import BAD


# ---------------------------------------------------------------------------
# Host (numpy, uint64) — golden model + DB-build path
# ---------------------------------------------------------------------------

def _bitrev_groups_u64(x: np.ndarray) -> np.ndarray:
    """Reverse the order of the 32 2-bit groups of each uint64 (in place safe).

    Written with explicit out= buffers: the naive expression allocated six
    fresh W-sized temporaries per call (page-fault bound at DB-build
    sizes)."""
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    t = np.bitwise_and(x, m2)
    np.left_shift(t, np.uint64(2), out=t)
    u = np.right_shift(x, np.uint64(2))
    np.bitwise_and(u, m2, out=u)
    np.bitwise_or(t, u, out=t)
    np.bitwise_and(t, m4, out=u)
    np.left_shift(u, np.uint64(4), out=u)
    np.right_shift(t, np.uint64(4), out=t)
    np.bitwise_and(t, m4, out=t)
    np.bitwise_or(u, t, out=u)
    return u.byteswap()


def window_kmers_np(codes: np.ndarray, k: int):
    """All-window canonical k-mers of a 1-D code array (host side).

    Returns (canonical uint64 [W], valid bool [W]) with W = max(L - k + 1, 0).
    valid[i] is False iff window i contains a non-CGAT base.

    Implementation: 2-bit codes are packed into uint64 words (32 bases/word,
    base i at bit 2*(i%32) of word i//32); each window's 64-bit little-endian
    slice is two word fetches + a variable shift, from which the straight
    k-mer is a 2-bit-group reversal and the reverse complement a XOR — ~10
    vector ops total instead of the former k-iteration shifted-OR loop
    (ref semantics: core util/CGAT.java kMerToLongStraight/Reverse).
    """
    L = len(codes)
    W = max(L - k + 1, 0)
    if W == 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    # pack pairwise in uint8 (2 bases -> 4 bits -> 1 byte = 4 bases), then
    # view the little-endian byte stream directly as uint64 words — no wide
    # temporary and no reduction
    n_words = (L + 31) // 32 + 1          # +1 pad word for q+1 fetches
    cpad = np.zeros(n_words * 32, np.uint8)
    np.bitwise_and(codes, 3, out=cpad[:L])
    b0 = cpad[0::2] | (cpad[1::2] << 2)
    b1 = b0[0::2] | (b0[1::2] << 4)
    words = b1.view(np.uint64)

    # index vectors via tile/repeat of the 32-periodic pattern (cheaper than
    # arange + mask/shift temporaries at this size)
    nq = (W + 31) >> 5
    q = np.repeat(np.arange(nq, dtype=np.intp), 32)[:W]
    r = np.tile(np.arange(0, 64, 2, dtype=np.uint64), nq)[:W]
    lo = words.take(q)
    lo >>= r
    # (w << 1) << (63 - r) == w << (64 - r), giving 0 at r == 0 without a where
    q += 1                                 # pad word guarantees q+1 in range
    hi = words.take(q)
    hi <<= np.uint64(1)
    np.subtract(np.uint64(63), r, out=r)
    hi <<= r
    v = lo
    v |= hi                                # base i+t at bits [2t, 2t+2)

    straight = _bitrev_groups_u64(v) >> np.uint64(64 - 2 * k)
    mask_2k = np.uint64((1 << (2 * k)) - 1)
    comp = np.uint64(0x5555555555555555) & mask_2k
    reverse = (v & mask_2k) ^ comp

    bad = codes > 3
    cc = np.zeros(L + 1, dtype=np.int32)
    np.cumsum(bad, out=cc[1:])
    valid = (cc[k:] - cc[:W]) == 0
    return np.maximum(straight, reverse), valid


def split_u64(x: np.ndarray):
    """Split uint64 keys into (hi, lo) uint32 arrays."""
    x = x.astype(np.uint64)
    return (x >> np.uint64(32)).astype(np.uint32), (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def merge_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


# ---------------------------------------------------------------------------
# Device (jax, uint32 pairs)
# ---------------------------------------------------------------------------

def window_kmers(codes: jax.Array, lengths: jax.Array, k: int):
    """All-window canonical k-mers for a padded batch of sequences.

    Args:
      codes: [B, L] uint8 2-bit codes, BAD (255) for non-CGAT bases and padding.
      lengths: [B] int32 true sequence lengths.
      k: k-mer length (static, 1..31).

    Returns:
      hi, lo: [B, W] uint32 canonical k-mer halves (garbage where not clean).
      clean:  [B, W] bool — window has no bad base.
      exists: [B, W] bool — window lies within the read (i < len - k + 1).

    A window that exists but is not clean is an INVALID window in the
    reference's sense (counts as a read tax error and prints as an 'A' segment,
    ref: match/FastqKMerMatcher.java:371-379,601-603).
    """
    B, L = codes.shape
    W = L - k + 1
    assert W >= 1, "padded length must be >= k"
    c32 = codes.astype(jnp.uint32)
    s_hi = jnp.zeros((B, W), jnp.uint32)
    s_lo = jnp.zeros((B, W), jnp.uint32)
    r_hi = jnp.zeros((B, W), jnp.uint32)
    r_lo = jnp.zeros((B, W), jnp.uint32)
    for j in range(k):
        cj = c32[:, j:j + W] & jnp.uint32(3)
        cr = cj ^ jnp.uint32(1)
        s = 2 * (k - 1 - j)
        r = 2 * j
        if s >= 32:
            s_hi = s_hi | (cj << (s - 32))
        else:
            s_lo = s_lo | (cj << s)
        if r >= 32:
            r_hi = r_hi | (cr << (r - 32))
        else:
            r_lo = r_lo | (cr << r)
    # canonical = unsigned max of (straight, reverse) as 64-bit values
    take_s = (s_hi > r_hi) | ((s_hi == r_hi) & (s_lo >= r_lo))
    hi = jnp.where(take_s, s_hi, r_hi)
    lo = jnp.where(take_s, s_lo, r_lo)
    # validity: no bad base in window, window within read
    bad = (codes > 3).astype(jnp.int32)
    cc = jnp.cumsum(bad, axis=1)
    cc = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), cc], axis=1)
    clean = (cc[:, k:] - cc[:, :W]) == 0
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    exists = pos < (lengths[:, None] - (k - 1))
    return hi, lo, clean, exists
