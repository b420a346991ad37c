"""A numpy model of the fragment maps of ``csrc/quant_flash_attention.cu``
(the int8 tensor-core encoder attention: its row-block kernel and its
long-key kernel), held here on the CPU, where the kernels cannot run,
against the plain versions they must equal on the card.

The model follows the PTX definition of ``mma.sync.m16n8k32`` (s8 x s8 ->
s32) and of ``ldmatrix.x4`` lane by lane, and reads the shared-memory
tiles at the byte offsets the kernel computes (rows ``DP + 16`` bytes
apart). It shows that:

* ``S = Q K^T`` from ldmatrix'ed q and K fragments puts row ``g + 8 h``,
  key ``8 n + 2 t + e`` of a 32-key chunk in lane ``(g, t)``'s element
  ``2 h + e`` of n-tile ``n``;
* the key-permuted ``P.V`` (the score fragment taken as the code A
  fragment, V's B fragment read 4 key rows a word and transposed 4 x 4
  bytes) equals the plain int32 ``c @ v``, padded keys and dims included,
  and the all-ones product gives V's column sums;
* the lanes' partial sums and butterfly add a row's exponentials in the
  order of ``softmax_sum`` (lane l of a warp adds keys l, l + 32, ...),
  bit for bit;
* the reads of every ldmatrix phase and of the V words, the row-block
  kernel's float2 score stores and its accumulator atomics fall in
  distinct banks; ``__byte_perm``'s selectors transpose 4 x 4 bytes;
* the row-block kernel's lanes-over-keys sum and the long-key kernel's
  fragment sum are one order, and the codes and requantized outputs they
  take with a multiply away from a half-integer are the divides'.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantize import int_matmul
from repro_torch.kernels import flash_attention as FA

LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3


def _bytes(word, i):
    """Signed byte i of uint32 words."""
    return ((word >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(
        np.uint8).view(np.int8).astype(np.int64)


def _pack(b):
    """(..., 4) int8 bytes -> (...) uint32 words, byte 0 lowest."""
    u = np.asarray(b, np.int64).astype(np.int8).view(np.uint8).astype(
        np.uint32)
    return u[..., 0] | u[..., 1] << 8 | u[..., 2] << 16 | u[..., 3] << 24


def mma_s8(d, a, b):
    """d (32, 4) int64 += a (32, 4) x b (32, 2) as mma.sync.m16n8k32:
    A[g][4t+i] is byte i of lane (g, t)'s a0, A[g+8][..] of a1, A[g][16+4t+i]
    of a2, A[g+8][16+..] of a3; B[4t+i][g] byte i of b0, B[16+4t+i][g] of
    b1; lane (g, t) holds D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for i in range(4):
        A[G, 4 * T + i] = _bytes(a[:, 0], i)
        A[G + 8, 4 * T + i] = _bytes(a[:, 1], i)
        A[G, 16 + 4 * T + i] = _bytes(a[:, 2], i)
        A[G + 8, 16 + 4 * T + i] = _bytes(a[:, 3], i)
        B[4 * T + i, G] = _bytes(b[:, 0], i)
        B[16 + 4 * T + i, G] = _bytes(b[:, 1], i)
    D = A @ B
    return d + np.stack([D[G, 2 * T], D[G, 2 * T + 1], D[G + 8, 2 * T],
                         D[G + 8, 2 * T + 1]], axis=1)


def ldmatrix_x4(smem, addr):
    """Lane l gives the address of row l % 8 of matrix l // 8 (16 bytes);
    lane (g, t) receives word t of row g of each matrix: (32, 4) uint32."""
    out = np.zeros((32, 4), np.uint32)
    for m in range(4):
        rows = addr[8 * m + G]
        out[:, m] = _pack(np.stack([smem[rows + 4 * T + i] for i in range(4)],
                                   axis=1).view(np.int8))
    return out


def word(smem, addr):
    return _pack(np.stack([smem[addr + i] for i in range(4)],
                          axis=1).view(np.int8))


def transpose_4x4(r):
    """int8_mma.cuh's __byte_perm transpose: byte i of o[c] is byte c of
    r[i]."""
    return [_pack(np.stack([_bytes(r[i], c) for i in range(4)], axis=1))
            for c in range(4)]


def tile(x, dp, rows):
    """(n, hd) int8 rows staged as the kernel stages them: `rows` rows of
    DP + 16 bytes, zero past hd and past n."""
    rb = dp + 16
    out = np.zeros((rows, rb), np.int8)
    out[:x.shape[0], :x.shape[1]] = x
    return out.reshape(-1).view(np.uint8), rb


def q_fragments(q16, dp):
    """A fragments of a warp's 16 q rows, one per 32-byte k-step."""
    smem, rb = tile(q16, dp, 16)
    row = (LANES & 7) + ((LANES >> 3) & 1) * 8
    return [ldmatrix_x4(smem, row * rb + 16 * (2 * ks + (LANES >> 4)))
            for ks in range(dp // 32)]


def score_fragments(qf, kt, ch, dp):
    """The int32 scores of 32-key chunk ch of a 64-key K tile: 4 n-tiles
    of (32, 4)."""
    smem, rb = tile(kt, dp, 64)
    sa = [np.zeros((32, 4), np.int64) for _ in range(4)]
    for ks in range(dp // 32):
        for pr in range(2):
            row = 32 * ch + 16 * pr + (LANES & 7) + ((LANES >> 4) << 3)
            bb = ldmatrix_x4(smem, row * rb + 16 * (2 * ks
                                                    + ((LANES >> 3) & 1)))
            sa[2 * pr] = mma_s8(sa[2 * pr], qf[ks], bb[:, 0:2])
            sa[2 * pr + 1] = mma_s8(sa[2 * pr + 1], qf[ks], bb[:, 2:4])
    return sa


def chunk_keys(ch):
    """Key (in the tile) of lane (g, t)'s element e of n-tile n."""
    return [[32 * ch + 8 * n + 2 * T + (e & 1) for e in range(4)]
            for n in range(4)]


def code_a_fragment(codes, ch):
    """The code A fragment built from the lane's own score positions:
    byte 2 (n % 2) + e % 2 of a[h + 2 (n // 2)] is row g + 8 h, key
    32 ch + 8 n + 2 t + e % 2."""
    a = np.zeros((32, 4, 4), np.int64)
    for n in range(4):
        for e in range(4):
            h = e >> 1
            key = 32 * ch + 8 * n + 2 * T + (e & 1)
            a[:, h + 2 * (n >> 1), 2 * (n & 1) + (e & 1)] = \
                codes[G + 8 * h, key]
    return _pack(a)


def v_fragments(vt, ch, gr, dp):
    """V's B fragments for dim group gr over chunk ch: lane (g, t) reads
    word g of the group from key rows 16 hh + 8 (i // 2) + 2 t + i % 2 and
    transposes: bq[hh][c] is n-tile c's b_hh."""
    smem, rb = tile(vt, dp, 64)
    out = []
    for hh in range(2):
        r = [word(smem, (32 * ch + 16 * hh + 8 * (i >> 1) + 2 * T + (i & 1))
                  * rb + 32 * gr + 4 * G) for i in range(4)]
        out.append(transpose_4x4(r))
    return out


def pv_model(codes, vt, dp):
    """acc[n-tile 4 gr + c] (32, 4) of the warp's 16 rows over a 64-key
    tile, and the ones-product column sums vs[gr][c]."""
    acc = [np.zeros((32, 4), np.int64) for _ in range(dp // 8)]
    vs = [[np.zeros((32, 4), np.int64) for _ in range(4)]
          for _ in range(dp // 32)]
    ones = np.full((32, 4), 0x01010101, np.uint32)
    for ch in range(2):
        a = code_a_fragment(codes, ch)
        for gr in range(dp // 32):
            bq = v_fragments(vt, ch, gr, dp)
            for c in range(4):
                b = np.stack([bq[0][c], bq[1][c]], axis=1)
                acc[4 * gr + c] = mma_s8(acc[4 * gr + c], a, b)
                vs[gr][c] = mma_s8(vs[gr][c], ones, b)
    return acc, vs


# (DP, hd, valid keys of the 64-key tile)
FRAGMENT_CASES = [(32, 16, 64), (32, 20, 37), (64, 64, 64), (64, 64, 9),
                  (128, 100, 50), (128, 128, 64), (256, 256, 33)]


@pytest.mark.parametrize("dp,hd,n", FRAGMENT_CASES)
def test_score_fragments_are_q_k_transposed(dp, hd, n):
    rng = np.random.default_rng(dp + hd + n)
    q16 = rng.integers(-128, 128, (16, hd)).astype(np.int8)
    kt = rng.integers(-128, 128, (n, hd)).astype(np.int8)
    want = np.zeros((16, 64), np.int64)
    want[:, :n] = q16.astype(np.int64) @ kt.astype(np.int64).T
    qf = q_fragments(q16, dp)
    for ch in range(2):
        sa = score_fragments(qf, kt, ch, dp)
        keys = chunk_keys(ch)
        for nt in range(4):
            for e in range(4):
                np.testing.assert_array_equal(
                    sa[nt][:, e], want[G + 8 * (e >> 1), keys[nt][e]])


@pytest.mark.parametrize("dp,hd,n", FRAGMENT_CASES)
def test_key_permuted_pv_is_the_int32_product(dp, hd, n):
    """Random codes over every key of the tile (padded keys carry codes
    too, as zero V rows must silence them) against int32 c @ v."""
    rng = np.random.default_rng(7 * dp + hd + n)
    codes = rng.integers(-128, 128, (16, 64)).astype(np.int8)
    vt = rng.integers(-128, 128, (n, hd)).astype(np.int8)
    acc, vs = pv_model(codes, vt, dp)
    want = codes[:, :n].astype(np.int64) @ vt.astype(np.int64)
    want_t = int_matmul(torch.from_numpy(codes[:, :n].copy()),
                        torch.from_numpy(vt.copy())).numpy()
    np.testing.assert_array_equal(want, want_t)
    colsum = vt.astype(np.int64).sum(0)
    for gr in range(dp // 32):
        for c in range(4):
            for h in range(2):
                for j in range(2):
                    dim = 32 * gr + 8 * T + 4 * j + c
                    got = acc[4 * gr + c][:, 2 * h + j]
                    ok = dim < hd
                    np.testing.assert_array_equal(
                        got[ok], want[G[ok] + 8 * h, dim[ok]])
                    np.testing.assert_array_equal(got[~ok], 0)
            # warp c's ones-product: row g of tile c, column 2 t + j
            for j in range(2):
                dim = 32 * gr + 8 * T + 4 * j + c
                got = vs[gr][c][:, j]
                ok = dim < hd
                np.testing.assert_array_equal(got[ok], colsum[dim[ok]])


def test_pv_with_zero_point_is_the_plain_accumulator():
    """acc + 128 vsum over every key, masked ones included, is the plain
    version's int_matmul(c, v) - INT8_MIN * vsum."""
    rng = np.random.default_rng(3)
    codes = rng.integers(-128, 128, (16, 64)).astype(np.int8)
    codes[:, 40:] = -128                      # masked keys: p = 0
    vt = rng.integers(-128, 128, (50, 64)).astype(np.int8)
    acc, vs = pv_model(codes, vt, 64)
    plain = (int_matmul(torch.from_numpy(codes[:, :50].copy()),
                        torch.from_numpy(vt.copy()))
             + 128 * torch.from_numpy(vt.astype(np.int32)).sum(0)).numpy()
    vsum = np.zeros(64, np.int64)
    for c in range(4):
        for j in range(2):
            dim = 8 * T + 4 * j + c
            vsum[dim] = vs[0][c][:, j]
    for c in range(4):
        for h in range(2):
            for j in range(2):
                dim = 8 * T + 4 * j + c
                np.testing.assert_array_equal(
                    acc[c][:, 2 * h + j] + 128 * vsum[dim],
                    plain[G + 8 * h, dim])


def fragment_sum(e):
    """A row's sum of exponentials as the kernel adds it: lane (g, t) keeps
    part[n][e'] for the keys 8 n + 2 t + e' of every 32-key chunk, in chunk
    order (keys past the row skipped); then its n ^ 2 and n ^ 1 pairs, the
    lanes t ^ 2 and t ^ 1 (shuffles), and its own e' ^ 1. float32."""
    e = np.asarray(e, np.float32)
    S = e.shape[-1]
    part = np.zeros((4, 4, 2), np.float32)          # [t][n][e']
    for c0 in range(0, S, 32):
        for t in range(4):
            for n in range(4):
                for ep in range(2):
                    j = c0 + 8 * n + 2 * t + ep
                    if j < S:
                        part[t, n, ep] = np.float32(part[t, n, ep] + e[j])
    r = np.zeros((4, 2), np.float32)
    for t in range(4):
        for ep in range(2):
            a0 = np.float32(part[t, 0, ep] + part[t, 2, ep])
            a1 = np.float32(part[t, 1, ep] + part[t, 3, ep])
            r[t, ep] = np.float32(a0 + a1)
    r = np.float32(r + r[[2, 3, 0, 1]])             # shuffle xor 2
    r = np.float32(r + r[[1, 0, 3, 2]])             # shuffle xor 1
    sums = np.float32(r[:, 0] + r[:, 1])
    assert (sums == sums[0]).all()                  # every lane agrees
    return sums[0]


@pytest.mark.parametrize("S", [1, 7, 31, 32, 33, 64, 100, 128, 300, 512])
def test_fragment_sum_is_the_warp_order(S):
    """Bit for bit the plain version's softmax_sum, on exponentials of
    widely spread magnitudes (where the order moves the last bit)."""
    rng = np.random.default_rng(S)
    rows = np.exp(rng.uniform(-30, 0, (6, S))).astype(np.float32)
    rows[0, ::3] = 0.0                               # masked keys
    rows[1] = 1.0                                    # an all-padding row
    want = FA.softmax_sum(torch.from_numpy(rows)).numpy()[:, 0]
    got = np.array([fragment_sum(r) for r in rows], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dp", [32, 64, 128, 256])
def test_tile_reads_fall_in_distinct_banks(dp):
    """Rows DP + 16 bytes apart: each ldmatrix phase (8 rows of 16 bytes)
    covers the 32 banks once, and so does each V word read of a warp (4 key
    rows x 8 words)."""
    rb = dp + 16

    def banks(addr):
        return (np.asarray(addr) // 4) % 32
    for base in (0, 8, 16, 24, 32, 40, 48, 56):
        for c in range(dp // 16):
            rows = base + np.arange(8)
            b = banks((rows[:, None] * rb + 16 * c + 4 * np.arange(4))
                      .reshape(-1))
            assert len(set(b.tolist())) == 32
    for hh in range(2):
        for i in range(4):
            for gr in range(dp // 32):
                row = 16 * hh + 8 * (i >> 1) + 2 * T + (i & 1)
                assert len(set(banks(row * rb + 32 * gr + 4 * G)
                               .tolist())) == 32


@pytest.mark.parametrize("Sk", [8, 128, 300, 512, 1408])
def test_row_block_buffers_fall_in_distinct_banks(Sk):
    """The row-block kernel's float score rows (padded key axis + 8 floats
    apart): a half-warp's float2 stores of one n-tile (rows g, keys
    8 n + 2 t) cover 16 distinct 8-byte slots of the 128 bytes; and its
    accumulator rows (DP + 1 words apart): a warp's atomics of one
    fragment element fall in 32 banks."""
    skp = -(-Sk // 128) * 128
    es = skp + 8
    for half in range(2):
        lanes = LANES[16 * half:16 * (half + 1)]
        for n in range(4):
            for h in range(2):
                for kw in range(4):
                    addr = 4 * ((16 + (lanes >> 2) + 8 * h) * es
                                + 32 * kw + 8 * n + 2 * (lanes & 3))
                    assert len(set(((addr // 8) % 16).tolist())) == 16
    for dp in (32, 64, 128, 256):
        for gr in range(dp // 32):
            for c in range(4):
                for e in range(4):
                    row = G + 8 * (e >> 1)
                    d = 32 * gr + 8 * T + 4 * (e & 1) + c
                    assert len(set(((row * (dp + 1) + d) % 32).tolist())) \
                        == 32


def byte_perm(x, y, s):
    """PTX prmt (CUDA's __byte_perm) with selectors 0-7: byte i of the
    result is byte (nibble i of s) of the 8 bytes (x, y)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def test_byte_perm_selectors_transpose_4x4_bytes():
    """transpose_4x4's selectors move byte c of r[i] to byte i of o[c], the
    map the numpy model's transpose_4x4 assumes."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        r = [int(x) for x in rng.integers(0, 2**32, 4, dtype=np.uint64)]
        t0, t1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[2], r[3], 0x5140)
        t2, t3 = byte_perm(r[0], r[1], 0x7362), byte_perm(r[2], r[3], 0x7362)
        o = [byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
             byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632)]
        want = transpose_4x4([np.array([x], np.uint32) for x in r])
        for c in range(4):
            assert o[c] == int(want[c][0])


def row_block_sum(e):
    """The row-block kernel's row sum: lane l adds keys l, l + 32, ... of
    the row's exponentials in turn (float32), then shuffles over 16, 8, 4,
    2, 1."""
    e = np.asarray(e, np.float32)
    part = np.zeros(32, np.float32)
    for j in range(e.shape[-1]):
        part[j % 32] = np.float32(part[j % 32] + e[j])
    for off in (16, 8, 4, 2, 1):
        part = np.float32(part + part[LANES ^ off])
    assert (part == part[0]).all()
    return part[0]


@pytest.mark.parametrize("S", [1, 31, 33, 128, 300, 512, 1408])
def test_row_block_sum_is_the_fragment_sum(S):
    """Both kernels add a row's exponentials in one order, bit for bit:
    the row-block kernel's lanes over keys and the long-key kernel's
    fragment partials (and both are softmax_sum's)."""
    rng = np.random.default_rng(S + 1)
    rows = np.exp(rng.uniform(-30, 0, (4, S))).astype(np.float32)
    a = np.array([row_block_sum(r) for r in rows], np.float32)
    b = np.array([fragment_sum(r) for r in rows], np.float32)
    want = FA.softmax_sum(torch.from_numpy(rows)).numpy()[:, 0]
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    np.testing.assert_array_equal(a.view(np.int32), want.view(np.int32))


def rint_near(x):
    """The kernels' rint_near on float32 x (|x| <= 256): x + 1.5 * 2^23
    rounds x to an integer, half to even, in the sum's low bits; `near`
    where x lies within 2^-12 of a half-integer (the kernels divide)."""
    f32 = np.float32
    t = (x + f32(12582912.0)).astype(f32)
    r = (t - f32(12582912.0)).astype(f32)
    near = np.abs(x - r) >= f32(0.5) - f32(2.0 ** -12)
    return t.view(np.int32).astype(np.int64) - 0x4B400000, near


def code_model(e, s, ps):
    """code_fast and its fallback: the codes from e * (1 / (s * ps)),
    clipped at 256, where rint_near decides, else the two divides'; and
    the divides' codes."""
    f32 = np.float32
    exact = np.clip(np.rint((e / s).astype(f32) / ps).astype(f32) - f32(128),
                    -128, 127)
    inv = (f32(1) / (s * ps).astype(f32)).astype(f32)
    c, near = rint_near(np.minimum((e * inv).astype(f32), f32(256)))
    return np.where(near, exact, np.minimum(c, 255) - 128), exact, near


def requant_model(o, os_):
    """requant: clip(rint(o / os)) from o * (1 / os), clipped at +-256,
    where rint_near decides, else the divide's."""
    f32 = np.float32
    exact = np.clip(np.rint((o / os_).astype(f32)), -128, 127)
    x = np.clip((o * (f32(1) / os_).astype(f32)).astype(f32), f32(-256),
                f32(256))
    c, near = rint_near(x)
    return np.where(near, exact, np.clip(c, -128, 127)), exact, near


@pytest.mark.parametrize("seed", range(4))
def test_divide_free_codes_are_the_divides(seed):
    """Away from a half-integer the kernels take a code as e * (1 / (sum
    * ps)) and a requantized output as o * (1 / os), a multiply each, not
    the plain version's IEEE divides: the product is within 6 (3) ulps of
    the divides' quotient, under the 2^-12 margin at |x| < 256. Held
    against the divides on random rows, codes near every half-integer
    (some inside the margin, which divide, some just outside it, which do
    not) and quotients past 256."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n = 200_000
    s = (1 + rng.uniform(0, 4096, n)).astype(f32)
    ps = (10.0 ** rng.uniform(-5, -0.5, n)).astype(f32)
    k = rng.integers(0, 300, n) + 0.5
    off = rng.choice([0.0, 1.0, -1.0], n) * (2.0 ** -12) * rng.uniform(
        0.5, 2.0, n)
    for e in (rng.uniform(0, 1, n).astype(f32),
              np.minimum((k + off) * s.astype(np.float64) * ps, 1.0)
              .astype(f32)):
        got, want, near = code_model(e, s, ps)
        np.testing.assert_array_equal(got, want)
    os_ = (10.0 ** rng.uniform(-3, 0, n)).astype(f32)
    kq = rng.integers(-300, 300, n) + 0.5
    for o in (rng.normal(0, 3, n).astype(f32),
              ((kq + off) * os_.astype(np.float64)).astype(f32)):
        got, want, near = requant_model(o, os_)
        np.testing.assert_array_equal(got, want)
