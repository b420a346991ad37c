"""A torch model of the row layout of ``csrc/addnorm_quant.cu`` (the fused
residual add + norm + requantize), held here on the CPU, where the kernel
cannot run, against ``addnorm_quant.row_sum``, the order in which every
norm of the port sums and which the kernel must reproduce bit for bit.

``row_sum`` models 256 threads: thread t adds x[t], x[t + 256], ... in
turn, each warp of 32 adds its partials in a butterfly (offsets 16, 8, 4,
2, 1), and the 8 warp sums are added in turn. The kernel holds a row in 64
physical threads. The model follows it element by element:

* row lane l loads the float4s at elements 256 k + 4 l (k = 0 .. the
  plan's float4s a thread, past D zeros), so it holds virtual threads
  4 l .. 4 l + 3 for every k and folds over k in its 4 registers;
* the butterfly's offsets 16, 8 and 4 are shuffles to lanes l ^ 4, l ^ 2
  and l ^ 1 (index permutations of the 64 lanes, within a warp), and 2
  and 1 are adds between the registers c ^ 2 and c ^ 1;
* lanes 0, 8, .., 56 write the 8 virtual-warp sums to shared memory, and
  they are added in turn;
* rows past the register plan stream: the same fold over every k, h read
  back from where the first read wrote it.

Both reductions (the mean, the squared deviations from it) and RMSNorm's
sum of squares equal ``row_sum`` bit for bit at every width listed, and
the modelled kernel's h and codes equal ``addnorm_quant_plain``'s.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantize import divide
from repro_torch.kernels import addnorm_quant as AQ

WIDTHS = [100, 768, 896, 3072, 4864, 7168, 12288, 20000, 1003, 8192]
LANES = torch.arange(AQ.ROW_THREADS)


def float4s_a_lane(D: int) -> int:
    """The float4s a row of D needs from each of its 64 lanes."""
    nvec = -(-D // 4)
    return -(-nvec // AQ.ROW_THREADS)


def lanes_of(D: int, M: int = 8, streamed: bool = False) -> torch.Tensor:
    """(k, lane, c) -> element index of a row (-1 past D): k over the
    float4s a thread holds under the kernel's plan, or, where the row
    streams, over the float4s the row needs."""
    vpt = AQ.plan(M, D)[0]
    nk = float4s_a_lane(D) if streamed or not vpt else vpt
    k = torch.arange(nk)[:, None, None]
    c = torch.arange(4)[None, None, :]
    e = 4 * (LANES[None, :, None] + AQ.ROW_THREADS * k) + c
    return torch.where(e < D, e, -1)


def kernel_sum(v: torch.Tensor, M: int = 8,
               streamed: bool = False) -> torch.Tensor:
    """(R, D) -> (R, 1), summed as the CUDA kernel sums a row."""
    R, D = v.shape
    idx = lanes_of(D, M, streamed)
    padded = torch.cat([v, torch.zeros((R, 1), dtype=v.dtype)], dim=1)
    held = padded[:, idx]                     # (R, k, lane, c); zeros past D
    p = held[:, 0]
    for k in range(1, held.shape[1]):         # each register's fold over k
        p = p + held[:, k]
    for off in (4, 2, 1):                     # shuffles: offsets 16, 8, 4
        p = p + p[:, LANES ^ off]
    w = (p[..., 0] + p[..., 2]) + (p[..., 1] + p[..., 3])   # offsets 2, 1
    red = w[:, ::8]                           # lanes 0, 8, ..: the words
    t = red[:, 0]
    for j in range(1, red.shape[1]):
        t = t + red[:, j]
    return t[:, None]


def kernel_addnorm(x, res, bias, gamma, beta, s, kind, M=8, eps=1e-6):
    """(h, q) as the modelled kernel computes them."""
    h = (x * 1.0 + res) + bias
    D = h.shape[-1]
    if kind == "layernorm":
        mu = divide(kernel_sum(h, M), D)
        var = divide(kernel_sum(torch.square(h - mu), M), D)
        y = (h - mu) * torch.reciprocal(torch.sqrt(var + eps)) * gamma
        if beta is not None:
            y = y + beta
    else:
        var = divide(kernel_sum(torch.square(h), M), D)
        y = h * torch.reciprocal(torch.sqrt(var + eps)) * gamma
    q = torch.clamp(torch.round(y / s), -128, 127).to(torch.int8)
    return h, q


def _rows(D, seed, R=3):
    """Rows whose sums round differently in different orders: a spread of
    magnitudes and an offset, so the mean and the deviations both carry
    rounding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, D)) * np.exp(rng.uniform(-4, 4, (R, D)))
    return torch.from_numpy((x + 3.0).astype(np.float32))


def test_lane_register_map_is_the_virtual_threads():
    """Lane l, register c holds virtual thread 4 l + c of every k: virtual
    warp l >> 3 at virtual lane 4 (l & 7) + c; the shuffles to l ^ 4, ^ 2,
    ^ 1 are the virtual lanes 16, 8, 4 apart within the virtual warp, and
    c ^ 2, c ^ 1 the ones 2 and 1 apart."""
    l, c = LANES[:, None], torch.arange(4)[None, :]
    t = 4 * l + c
    assert sorted(t.reshape(-1).tolist()) == list(range(256))
    vw, vl = t >> 5, t & 31
    assert torch.equal(vw, (l >> 3).expand(-1, 4))
    assert torch.equal(vl, 4 * (l & 7) + c)
    for off, virtual in ((4, 16), (2, 8), (1, 4)):
        partner = 4 * (LANES[:, None] ^ off) + c
        assert torch.equal(partner >> 5, vw)              # the same warp
        assert torch.equal(partner & 31, vl ^ virtual)
        assert bool(((l ^ off) >> 5 == l >> 5).all())     # a warp shuffle
    for creg, virtual in ((2, 2), (1, 1)):
        assert torch.equal((4 * l + (c ^ creg)) & 31, vl ^ virtual)
    # each element of a row lands in one slot, at its virtual thread
    for D in (768, 896, 1003, 20000):
        idx = lanes_of(D)
        live = idx >= 0
        assert sorted(idx[live].tolist()) == list(range(D))
        assert torch.equal(idx[live] % 256, t.expand_as(idx)[live])


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("M", [8, 1024])
def test_kernel_sums_equal_row_sum(D, M):
    """The three sums of the kernel (h; (h - mu)^2; h^2) equal row_sum's
    bit for bit, in the register plan and streamed alike (the plan at M
    decides which; 12288 and 20000 stream)."""
    h = _rows(D, D + M)
    mu = divide(AQ.row_sum(h), D)
    for v in (h, torch.square(h - mu), torch.square(h)):
        assert torch.equal(kernel_sum(v, M), AQ.row_sum(v))


@pytest.mark.parametrize("D", [100, 768, 896, 3072, 4864, 7168])
def test_streamed_and_held_orders_agree(D):
    """The held fold over the plan's float4s (a power of two, the extra
    ones zero) and the streamed fold over the float4s the row needs give
    row_sum's bits: a row in the register plan could stream alike."""
    h = _rows(D, 7)
    assert lanes_of(D).shape[0] >= float4s_a_lane(D)
    mu = divide(AQ.row_sum(h), D)
    for v in (h, torch.square(h - mu)):
        assert torch.equal(kernel_sum(v), AQ.row_sum(v))
        assert torch.equal(kernel_sum(v, streamed=True), AQ.row_sum(v))


@pytest.mark.parametrize("D", [768, 896, 3072])
def test_the_order_is_not_free(D):
    """The model has teeth: the butterfly's register steps taken first, or
    a plain torch.sum, round differently from row_sum on these rows."""
    h = _rows(D, 11, R=16)
    want = AQ.row_sum(h)
    assert not torch.equal(h.sum(dim=-1, keepdim=True), want)
    R = h.shape[0]
    idx = lanes_of(D)
    p = torch.cat([h, torch.zeros((R, 1))], dim=1)[:, idx]
    acc = p[:, 0]
    for k in range(1, p.shape[1]):
        acc = acc + p[:, k]
    w = (acc[..., 0] + acc[..., 2]) + (acc[..., 1] + acc[..., 3])
    for off in (4, 2, 1):                     # offsets 2, 1 before 16, 8, 4
        w = w + w[:, LANES ^ off]
    red = w[:, ::8]
    t = red[:, 0]
    for j in range(1, 8):
        t = t + red[:, j]
    assert not torch.equal(t[:, None], want)


@pytest.mark.parametrize("D", [100, 768, 896, 7168, 12288, 20000])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_modelled_kernel_equals_the_plain_version(D, kind):
    rng = np.random.default_rng(D)
    M = 4
    x, res = (torch.from_numpy(rng.standard_normal((M, D)).astype(
        np.float32) * sc) for sc in (1.0, 2.0))
    bias = torch.from_numpy((0.1 * rng.standard_normal(D)).astype(np.float32))
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(D)).astype(
        np.float32))
    beta = (torch.from_numpy((0.1 * rng.standard_normal(D)).astype(
        np.float32)) if kind == "layernorm" else None)
    s = torch.tensor(0.025)
    h, q = kernel_addnorm(x, res, bias, gamma, beta, s, kind)
    h_ref, q_ref = AQ.addnorm_quant_plain(x, res, bias, gamma, beta, s,
                                          kind=kind)
    assert torch.equal(h, h_ref) and torch.equal(q, q_ref)


def test_plan_at_the_served_shapes():
    """The mirror of samp_addnorm_quant_plan: (float4s a thread, threads a
    row, rows a block) at the served shapes and at the widths around the
    register plan's edge."""
    assert AQ.plan(1024, 768) == (4, 64, 2)      # encoder forward
    assert AQ.plan(8, 896) == (4, 64, 1)         # qwen2 decode tick
    assert AQ.plan(8, 768) == (4, 64, 1)
    assert AQ.plan(263, 768) == (4, 64, 1)
    assert AQ.plan(264, 768) == (4, 64, 2)
    assert AQ.plan(8, 100) == (1, 64, 1)
    assert AQ.plan(8, 3072) == (16, 64, 1)
    assert AQ.plan(8, 7168) == (32, 64, 1)
    assert AQ.plan(8, 8192) == (32, 64, 1)
    assert AQ.plan(8, 8196) == (0, 64, 1)        # streamed
    assert AQ.plan(4, 16384) == (0, 64, 1)
    assert AQ.plan(1024, 20000) == (0, 64, 2)
    for D in range(1, 9000, 37):
        vpt, tpr, _ = AQ.plan(8, D)
        if vpt:                                  # the least power of two
            assert vpt * tpr * 4 >= D and (vpt == 1 or
                                           vpt // 2 * tpr * 4 < D)
        else:
            assert D > AQ.MAX_VEC * tpr * 4
