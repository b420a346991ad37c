"""The CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX (the machine with the card has none), so it runs there on its own,
without the suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The shapes cover what ``chip_smoke.py`` does not: ragged edges of the GEMM
tile (M, N not multiples of 64; K not a multiple of 8, which turns off the
8-byte loads), rows wider than the block, int8 inputs to addnorm, RMSNorm,
absent biases, addnorm and dynamic_quant rows past their register plans
(streamed, up to 40000 values) and addnorm's block plan, embedding rows
that do not split into float4s or tables off 16-byte alignment, and for the
attention kernel GQA, padded keys, an all-padding batch row, query counts
that are not a multiple of the 32-row tile, the softcap, 512 keys (which
need more than 48 KB of shared memory), key axes past a block's shared
memory (the long-key kernel, which must equal the row-block one bit for
bit) and head dims that are not a multiple of 4, and without the softcap
bit-for-bit equality with the plain version at every BERT bucket and at
512 keys (GQA, head dims 16 / 64 / 100 / 128, ragged and all-padding
rows, float and int8 output); for dynamic_quant exact codes and scales at
every served width, rounding ties, all-zero rows, rows that start off
16-byte alignment, and its block plan; for the paged decode kernel
head dims 16 to 256 and ones in between (80, 18), page sizes 3 to 128,
GQA groups of 1 to 48 (split over blocks past 32), per-token and per-head
scales, the two-pass uint8 softmax, page tables out of order with holes, a
slot of length 0, and the decode engine end to end; for the routed
expert GEMM capacities of 1 to 160 rows per expert, one and two token
groups, ragged D and F, static (scalar and per-expert) and per-token
scales, and the MoE engine end to end; for the float flash-attention kernel
every instantiated head dim and one padded up to the next, float32,
bfloat16 and float16, causal, window, softcap and no mask, logical blocks
(bq, bk) that differ from the kernel's tiles, rows with no valid key, and
GQA; and the fused backend at the shapes the decode and quantized
attention kernels once refused, which must launch them. The tensor-core
GEMM is also held at every shape ``tools/torch_gemm_ab.py`` times, at M
from 1 to 1024 across its split-K cut (M <= 32), with K off its 64-byte
stage and N = 128, to the plain version bit for bit where the epilogue is
one multiply (exact int32 sums); the float attention at 4096 keys under a
window in bfloat16, at head dim 256 in every dtype, and on rows whose
output cancels near 0 (where one 16-bit rounding of P would break 2e-4).
The paged decode kernel, split over a slot's pages, equals its plain
version bit for bit at every built head dim and page size at 1, 2, 8 and
20 splits and at 4096 cached tokens; the expert GEMM's tensor-core stream
at capacities 1 to 160 over 8 experts. The shapes the attention archs
serve are held there too: the decode kernel at granite-20b's group of 48,
deepseek-coder-33b's group of 7, gemma2-2b's head dim 256 over pages of
128 with softcap 50 and paligemma-3b's group of 8 at head dim 256 (through
the fused backend, bit for bit the reference's plain version), hubert's
head dim 80 in the quantized attention (bit for bit), and deepseek-v2's
160-expert stacks at decode and forward capacities. Head dims over 256
(260, 300, 320, 512) run the three attention kernels' wide kernels: the
quantized and the paged decode attention equal their plain versions bit for
bit, the float attention is within its budget.
"""
import ctypes
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import (addnorm_quant, backend, build,
                                 decode_attention, dynamic_quant, expert_gemm,
                                 flash_attention, fused_embed, ops,
                                 quant_linear)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / (a.abs().max() + 1e-9))


@pytest.mark.parametrize("M,K,N", [(1, 768, 768), (37, 768, 3072),
                                   (100, 3072, 768), (64, 36, 70),
                                   (130, 1030, 65)])
@pytest.mark.parametrize("act", [None, "gelu", "silu", "relu"])
@pytest.mark.parametrize("per_token", [False, True])
def test_quant_linear(dev, M, K, N, act, per_token):
    g = torch.Generator(device=dev).manual_seed(M * N + K)
    xq = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    ws = torch.rand(N, generator=g, device=dev) * 1e-3 + 1e-5
    xs = (torch.rand((M, 1), generator=g, device=dev) * 0.02 + 1e-3
          if per_token else torch.tensor(0.013, device=dev))
    b = torch.randn(N, generator=g, device=dev) if act else None
    before = quant_linear.launches
    y = quant_linear.quant_linear(xq, wq, ws, xs, bias=b, act=act)
    assert quant_linear.launches == before + 1
    y_ref = quant_linear.quant_linear_plain(xq, wq, ws, xs, bias=b, act=act)
    assert y.dtype == torch.float32 and y.shape == (M, N)
    assert _rel(y_ref, y) <= 1e-6
    os_ = torch.tensor(float(y_ref.abs().max()) / 100.0, device=dev)
    q = quant_linear.quant_linear(xq, wq, ws, xs, bias=b, act=act,
                                  out_scale=os_)
    q_ref = quant_linear.quant_linear_plain(xq, wq, ws, xs, bias=b, act=act,
                                            out_scale=os_)
    assert q.dtype == torch.int8
    assert int((q.int() - q_ref.int()).abs().max()) <= 1


def test_quant_linear_requant_ties(dev):
    """Outputs on exact ties (acc + 0.5 at unit scales) round half to even
    in the kernel's epilogue, as in the plain version."""
    g = torch.Generator(device=dev).manual_seed(12)
    M, K, N = 70, 40, 130
    xq = torch.randint(-3, 4, (M, K), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-3, 4, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    ones = torch.ones(N, device=dev)
    half = torch.full((N,), 0.5, device=dev)
    args = (xq, wq, ones, torch.tensor(1.0, device=dev))
    kw = dict(bias=half, out_scale=torch.tensor(1.0, device=dev))
    q = quant_linear.quant_linear(*args, **kw)
    assert q.equal(quant_linear.quant_linear_plain(*args, **kw))
    acc = xq.cpu().int() @ wq.cpu().int()
    assert q.cpu().equal(torch.round(acc + 0.5).clamp(-128, 127).to(
        torch.int8))


def _gemm_ab_shapes():
    """(M, K, N, act, per-token) of every shape tools/torch_gemm_ab.py
    times, read from the tool without running it."""
    path = Path(__file__).resolve().parents[1] / "tools" / "torch_gemm_ab.py"
    spec = importlib.util.spec_from_file_location("torch_gemm_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return sorted({shape[1:6] for shape in mod.SHAPES}, key=repr)


def _ql_operands(dev, M, K, N, per_token, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    xq = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    ws = torch.rand(N, generator=g, device=dev) * 1e-3 + 1e-5
    xs = (torch.rand((M, 1), generator=g, device=dev) * 0.02 + 1e-3
          if per_token else torch.tensor(0.013, device=dev))
    return xq, wq, ws, xs


@pytest.mark.parametrize("M,K,N,act,per_token", _gemm_ab_shapes())
def test_quant_linear_at_the_timed_shapes(dev, M, K, N, act, per_token):
    xq, wq, ws, xs = _ql_operands(dev, M, K, N, per_token, M + K + N)
    before = quant_linear.launches
    y = quant_linear.quant_linear(xq, wq, ws, xs, act=act)
    assert quant_linear.launches == before + 1
    y_ref = quant_linear.quant_linear_plain(xq, wq, ws, xs, act=act)
    assert _rel(y_ref, y) <= 1e-6
    os_ = torch.tensor(float(y_ref.abs().max()) / 100.0, device=dev)
    q = quant_linear.quant_linear(xq, wq, ws, xs, act=act, out_scale=os_)
    q_ref = quant_linear.quant_linear_plain(xq, wq, ws, xs, act=act,
                                            out_scale=os_)
    assert int((q.int() - q_ref.int()).abs().max()) <= 1


@pytest.mark.parametrize("M", [1, 7, 8, 16, 17, 33, 1024])
@pytest.mark.parametrize("K,N", [(896, 128), (1040, 4864), (200, 72),
                                 (6144, 1024)])
@pytest.mark.parametrize("per_token", [False, True])
def test_quant_linear_sums_are_exact(dev, M, K, N, per_token):
    """No bias, no activation: y = float(acc) * (x_scale * w_scale), one
    rounding of the int32 sum, so the kernel (split over K or not, K off
    the 64-byte stage, N = 128) equals the plain version bit for bit."""
    xq, wq, ws, xs = _ql_operands(dev, M, K, N, per_token, 7 * M + K)
    y = quant_linear.quant_linear(xq, wq, ws, xs)
    assert y.equal(quant_linear.quant_linear_plain(xq, wq, ws, xs))


def test_quant_linear_requant_ties_split_over_k(dev):
    """Exact ties at M = 8 and a K split over blocks: the last block's
    epilogue rounds half to even, as the plain version does."""
    g = torch.Generator(device=dev).manual_seed(13)
    M, K, N = 8, 896, 256
    assert quant_linear.quant_linear_splits(M, N, K) > 1
    xq = torch.randint(-3, 4, (M, K), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-3, 4, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    args = (xq, wq, torch.ones(N, device=dev), torch.tensor(1.0, device=dev))
    kw = dict(bias=torch.full((N,), 0.5, device=dev),
              out_scale=torch.tensor(1.0, device=dev))
    q = quant_linear.quant_linear(*args, **kw)
    assert q.equal(quant_linear.quant_linear_plain(*args, **kw))


def test_quant_linear_splits_mirror_the_library(dev):
    fn = build.function("samp_quant_linear_splits", (build.I,) * 3)
    for M in (1, 8, 16, 32, 33, 1024):
        for K, N in ((896, 896), (896, 128), (4864, 896), (6144, 6144),
                     (6144, 1024), (36, 70), (0, 64)):
            assert fn(M, N, K) == quant_linear.quant_linear_splits(M, N, K)


# the row-parallel GEMMs of a 2-way tensor-parallel mesh: BERT-base's attn
# and FFN outputs (K 384 / 1536 of 768 / 3072), qwen2-0.5b's (448 / 2432 of
# 896 / 4864), and the unsplit shapes they sum to
TP_ROW_SHAPES = [(384, 768), (1536, 768), (448, 896), (2432, 896),
                 (768, 768), (4864, 896)]


@pytest.mark.parametrize("M", [1, 8, 33, 1024])
@pytest.mark.parametrize("K,N", TP_ROW_SHAPES)
@pytest.mark.parametrize("act", [None, "gelu"])
def test_quant_linear_accumulator_mode(dev, M, K, N, act):
    """The accumulator mode returns the exact int32 product (split over K
    or not), its plain version's bit for bit; the two K halves' sums add
    to the whole product's; and the epilogue after the sum equals the
    kernel's own output, float and requantized: bit for bit with a bias and
    no activation (the row-parallel GEMMs of the served models), within
    the plain version's budget under GELU (tanhf against torch.tanh)."""
    xq, wq, ws, xs = _ql_operands(dev, M, K, N, True, 11 * M + K)
    before = quant_linear.launches
    acc = quant_linear.quant_linear_acc(xq, wq)
    assert quant_linear.launches == before + 1
    assert acc.dtype == torch.int32 and acc.equal(
        quant_linear.quant_linear_acc(xq.cpu(), wq.cpu()).to(dev))
    h = K // 2
    halves = (quant_linear.quant_linear_acc(xq[:, :h].contiguous(), wq[:h])
              + quant_linear.quant_linear_acc(xq[:, h:].contiguous(), wq[h:]))
    assert halves.equal(acc)
    b = torch.randn(N, generator=torch.Generator(device=dev).manual_seed(K),
                    device=dev)
    y = quant_linear.quant_linear(xq, wq, ws, xs, bias=b, act=act)
    y_ep = quant_linear.quant_linear_epilogue(acc, ws, xs, bias=b, act=act)
    os_ = torch.tensor(float(y.abs().max()) / 100.0, device=dev)
    q = quant_linear.quant_linear(xq, wq, ws, xs, bias=b, act=act,
                                  out_scale=os_)
    q_ep = quant_linear.quant_linear_epilogue(acc, ws, xs, bias=b, act=act,
                                              out_scale=os_)
    if act is None:
        assert y_ep.equal(y) and q_ep.equal(q)
    else:
        assert _rel(y, y_ep) <= 1e-6
        assert int((q.int() - q_ep.int()).abs().max()) <= 1


# the column-parallel GEMMs of a 2-way tensor-parallel mesh, whole: each
# rank runs half of N (qwen2-0.5b's wk / wv at 64, wq at 448, wg / wu at
# 2432; BERT-base's q / k / v at 384, wi at 1536)
TP_COL_SHAPES = [(896, 128), (896, 896), (896, 4864), (768, 768),
                 (768, 3072)]


@pytest.mark.parametrize("M", [1, 8, 1024])
@pytest.mark.parametrize("K,N", TP_COL_SHAPES)
def test_quant_linear_column_shards(dev, M, K, N):
    """A rank's half of a column-parallel weight, at any width (no tile
    minimum), gives the whole GEMM's columns bit for bit: the integer sums
    are exact and the epilogue is per column."""
    xq, wq, ws, xs = _ql_operands(dev, M, K, N, False, 5 * M + N)
    b = torch.randn(N, generator=torch.Generator(device=dev).manual_seed(N),
                    device=dev)
    y = quant_linear.quant_linear(xq, wq, ws, xs, bias=b)
    h = N // 2
    for lo, hi in ((0, h), (h, N)):
        part = quant_linear.quant_linear(
            xq, wq[:, lo:hi].contiguous(), ws[lo:hi].contiguous(), xs,
            bias=b[lo:hi].contiguous())
        assert part.equal(y[:, lo:hi])


@pytest.mark.parametrize("M,D", [(1, 768), (8, 896), (1024, 3072),
                                 (8, 4864), (5, 5000), (3, 40000)])
def test_dynamic_quant_scale_in_mode(dev, M, D):
    """Each rank's columns of a row coded at the whole row's amax (the
    row_amax operand) give the whole row's codes and scales bit for bit,
    at every block plan: one row a block, several, and streamed."""
    g = torch.Generator(device=dev).manual_seed(M + 3 * D)
    x = torch.randn((M, D), generator=g, device=dev) * 3
    x[-1] = 0.0
    q, s = dynamic_quant.dynamic_quant(x)
    amax = x.abs().amax(dim=-1)
    h = D // 2
    for part in (x[:, :h], x[:, h:]):
        part = part.contiguous()
        qp, sp = dynamic_quant.dynamic_quant(part, row_amax=amax)
        assert sp.equal(s)
        assert qp.equal(dynamic_quant.dynamic_quant_plain(part, amax)[0])
    qa, _ = dynamic_quant.dynamic_quant(x[:, :h].contiguous(), row_amax=amax)
    qb, _ = dynamic_quant.dynamic_quant(x[:, h:].contiguous(), row_amax=amax)
    assert torch.cat([qa, qb], dim=1).equal(q)


@pytest.mark.parametrize("M,D", [(1, 768), (33, 3072), (7, 100), (5, 5000)])
def test_dynamic_quant(dev, M, D):
    g = torch.Generator(device=dev).manual_seed(D)
    x = torch.randn((M, D), generator=g, device=dev) * 3
    (q, s), (q_ref, s_ref) = (dynamic_quant.dynamic_quant(x),
                              dynamic_quant.dynamic_quant_plain(x))
    assert q.equal(q_ref) and s.equal(s_ref) and s.shape == (M, 1)


# the widths a served path quantizes: BERT's M = 1024 rows of 768 / 3072,
# qwen2 decode's 8 of 896 / 4864, the MoE routed buffers' 24 of 6144 / 16384
DQ_SERVED = [(1024, 768), (1024, 3072), (8, 896), (8, 4864), (24, 6144),
             (24, 16384)]


@pytest.mark.parametrize("M,D", DQ_SERVED)
def test_dynamic_quant_at_the_served_widths(dev, M, D):
    """Codes and scales equal the plain version's bit for bit, with a few
    all-zero rows (scale 1e-8 / 127) and a row whose values span codes."""
    g = torch.Generator(device=dev).manual_seed(M + D)
    x = torch.randn((M, D), generator=g, device=dev) * 3
    x[M // 2] = 0.0
    x[-1] = 0.0
    (q, s), (q_ref, s_ref) = (dynamic_quant.dynamic_quant(x),
                              dynamic_quant.dynamic_quant_plain(x))
    assert q.equal(q_ref) and s.equal(s_ref)
    assert float(s[-1]) == float(torch.tensor(1e-8) / torch.tensor(127.0))


@pytest.mark.parametrize("M,D", [(8, 896), (1024, 768), (3, 100)])
def test_dynamic_quant_rounds_ties_to_even(dev, M, D):
    """x = (k + 0.5) s with s = 2^-4 exactly (amax 127 s): every code is a
    tie, rounded half to even as the plain version rounds it."""
    s = 0.0625
    k = torch.arange(D, device=dev) % 255 - 127          # -127 .. 127
    x = ((k.float() + 0.5).clamp(-127, 126.5) * s).repeat(M, 1)
    x[:, 0] = 127 * s
    (q, sc), (q_ref, sc_ref) = (dynamic_quant.dynamic_quant(x),
                                dynamic_quant.dynamic_quant_plain(x))
    assert float(sc[0]) == s
    assert q.equal(q_ref) and sc.equal(sc_ref)
    assert int((q[0, 1:].int() % 2).abs().sum()) == 0     # all even


@pytest.mark.parametrize("M,D", [(8, 896), (1024, 768), (5, 5000)])
def test_dynamic_quant_takes_rows_off_alignment(dev, M, D):
    """A contiguous view that starts 4 bytes past 16-byte alignment: the
    kernel reads it 4 bytes at a time, exactly."""
    g = torch.Generator(device=dev).manual_seed(D)
    base = torch.randn(M * D + 1, generator=g, device=dev)
    x = base[1:].view(M, D)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    (q, s), (q_ref, s_ref) = (dynamic_quant.dynamic_quant(x),
                              dynamic_quant.dynamic_quant_plain(x))
    assert q.equal(q_ref) and s.equal(s_ref)


def test_dynamic_quant_plan_holds_each_row_once(dev):
    """The kernel's block plan (float4s a thread, threads a row, rows a
    block): every element has one slot, a row's threads are whole warps
    of one block of at most 1024 threads (256 where rows share one), one
    float4 a thread below 264 rows where 1024 threads hold the row; the
    served widths' shapes; rows past the register plan (over 32768 values)
    streamed by 1024 threads, with codes and scales equal to the plain
    version's at 20000 (held) and 40000 (streamed) values."""
    fn = build.function("samp_dynamic_quant_plan",
                        (build.I, build.I, build.P), None)
    out = (ctypes.c_int * 3)()

    def plan(M, D):
        fn(M, D, ctypes.addressof(out))
        return tuple(out)
    for M in (1, 8, 24, 263, 264, 1024, 4096):
        for D in (1, 3, 100, 768, 896, 3072, 4864, 5000, 6144, 16384,
                  32768):
            vpt, tpr, rpb = plan(M, D)
            nvec = -(-D // 4)
            assert vpt in (1, 2, 4, 8) and tpr % 32 == 0 and tpr <= 1024
            assert tpr - 32 < -(-nvec // vpt) <= tpr
            if M < 264:
                assert rpb == 1 and (vpt == 1 or -(-nvec // (vpt // 2)) >
                                     1024)
            else:
                assert tpr * rpb <= 256 or rpb == 1
    assert [plan(M, D) for M, D in DQ_SERVED] == [
        (8, 32, 8), (8, 96, 2), (1, 224, 1), (2, 608, 1), (2, 768, 1),
        (4, 1024, 1)]
    assert plan(8, 32772) == plan(1024, 40000) == (0, 1024, 1)
    g = torch.Generator(device=dev).manual_seed(40000)
    for D in (20000, 40000):
        x = torch.randn((3, D), generator=g, device=dev) * 3
        x[1] = 0.0
        (q, s), (q_ref, s_ref) = (dynamic_quant.dynamic_quant(x),
                                  dynamic_quant.dynamic_quant_plain(x))
        assert q.equal(q_ref) and s.equal(s_ref)


# the served shapes (a BERT forward's 1024 rows of 768; a qwen2 decode
# tick's 8 of 896), rows past the register plan (12288, streamed), and a
# width off float4s (1003)
@pytest.mark.parametrize("M,D", [(1, 768), (50, 768), (9, 100), (4, 2000),
                                 (1024, 768), (8, 896), (3, 12288),
                                 (5, 1003)])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("int8_in", [False, True])
@pytest.mark.parametrize("beta", [False, True])
def test_addnorm_quant(dev, record_property, M, D, kind, int8_in, beta):
    """h equal to the plain version's bit for bit, the codes within the
    stated budget; the flipped codes are recorded (the kernel sums in
    row_sum's order, so 0 is expected)."""
    g = torch.Generator(device=dev).manual_seed(M + D)
    if int8_in:
        x = torch.randint(-128, 128, (M, D), generator=g, device=dev,
                          dtype=torch.int8)
        x_in = torch.tensor(0.03, device=dev)
    else:
        x, x_in = torch.randn((M, D), generator=g, device=dev), None
    res = torch.randn((M, D), generator=g, device=dev) * 2
    bias = torch.randn(D, generator=g, device=dev) * 0.1
    gamma = 1 + 0.1 * torch.randn(D, generator=g, device=dev)
    bt = 0.1 * torch.randn(D, generator=g, device=dev) if beta else None
    args = (x, res, bias, gamma, bt, torch.tensor(0.025, device=dev))
    h, q = addnorm_quant.addnorm_quant(*args, x_in_scale=x_in, kind=kind)
    h_ref, q_ref = addnorm_quant.addnorm_quant_plain(*args, x_in_scale=x_in,
                                                     kind=kind)
    assert h.equal(h_ref)
    diff = (q.int() - q_ref.int()).abs()
    record_property("flipped_codes", int((diff > 0).sum()))
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 5e-3


def test_addnorm_quant_plan_mirrors_the_library(dev):
    """samp_addnorm_quant_plan equals its Python mirror
    (``addnorm_quant.plan``) at the served shapes and across the widths
    around the register plan's edge and past it."""
    fn = build.function("samp_addnorm_quant_plan",
                        (build.I, build.I, build.P), None)
    out = (ctypes.c_int * 3)()
    for M in (1, 8, 263, 264, 1024):
        for D in (1, 3, 100, 256, 257, 768, 896, 1003, 3072, 4864, 7168,
                  8192, 8196, 12288, 16384, 20000, 40000):
            fn(M, D, ctypes.addressof(out))
            assert tuple(out) == addnorm_quant.plan(M, D), (M, D)


@pytest.mark.parametrize("N,D", [(1, 768), (300, 768), (17, 30),
                                 (1024, 768)])
@pytest.mark.parametrize("segments", [False, True])
def test_fused_embed(dev, N, D, segments):
    g = torch.Generator(device=dev).manual_seed(N + D)
    tok = torch.randn((1000, D), generator=g, device=dev)
    pos = torch.randn((512, D), generator=g, device=dev)
    seg = torch.randn((2, D), generator=g, device=dev) if segments else None
    ids = torch.randint(0, 1000, (N,), generator=g, device=dev)
    segs = (torch.randint(0, 2, (N,), generator=g, device=dev)
            if segments else None)
    positions = torch.arange(N, device=dev) % 128
    out = fused_embed.fused_embed(ids, tok, pos, seg, segs,
                                  positions=positions)
    assert out.equal(fused_embed.fused_embed_plain(ids, tok, pos, seg, segs,
                                                   positions=positions))


@pytest.mark.parametrize("segments", [False, True])
def test_fused_embed_takes_an_unaligned_table(dev, segments):
    """A token table that starts 4 bytes past 16-byte alignment: the kernel
    reads the rows 4 bytes at a time, exactly; ids out of range clamped."""
    g = torch.Generator(device=dev).manual_seed(7)
    N, D = 1024, 768
    tok = torch.randn(1000 * D + 1, generator=g, device=dev)[1:].view(1000, D)
    assert tok.is_contiguous() and tok.data_ptr() % 16 != 0
    pos = torch.randn((512, D), generator=g, device=dev)
    seg = torch.randn((2, D), generator=g, device=dev) if segments else None
    ids = torch.randint(-5, 1005, (N,), generator=g, device=dev)
    segs = (torch.randint(0, 2, (N,), generator=g, device=dev)
            if segments else None)
    positions = torch.arange(N, device=dev) % 128
    out = fused_embed.fused_embed(ids, tok, pos, seg, segs,
                                  positions=positions)
    assert out.equal(fused_embed.fused_embed_plain(ids, tok, pos, seg, segs,
                                                   positions=positions))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn((8, 16), device=dev)
    with pytest.raises(ValueError):
        dynamic_quant.dynamic_quant(x.t())              # not contiguous
    with pytest.raises(TypeError):
        dynamic_quant.dynamic_quant(x.double())
    xq = torch.zeros((8, 16), dtype=torch.int8, device=dev)
    wq = torch.zeros((16, 4), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        quant_linear.quant_linear(xq, wq, torch.ones(3, device=dev), 0.1)
    with pytest.raises(ValueError):
        quant_linear.quant_linear(xq, wq.cpu(), torch.ones(4, device=dev),
                                  0.1)
    # rows of any width: past the register plan the kernel streams, equal
    # to the plain version
    g = torch.Generator(device=dev).manual_seed(20000)
    for D in (20000, 40000):
        x, res = (torch.randn((2, D), generator=g, device=dev)
                  for _ in range(2))
        vec = torch.randn(D, generator=g, device=dev)
        for kind in ("layernorm", "rmsnorm"):
            args = (x, res, vec * 0.1, 1 + 0.1 * vec, vec * 0.05, 0.03)
            h, q = addnorm_quant.addnorm_quant(*args, kind=kind)
            h_ref, q_ref = addnorm_quant.addnorm_quant_plain(*args,
                                                             kind=kind)
            diff = (q.int() - q_ref.int()).abs()
            assert h.equal(h_ref) and int(diff.max()) <= 1
            assert float((diff > 0).float().mean()) < 5e-3


def test_counters_reset(dev):
    dynamic_quant.dynamic_quant(torch.randn((4, 8), device=dev))
    assert kernels.launch_counts()["dynamic_quant"] >= 1
    kernels.reset_launches()
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNEL_COUNTERS}


# (B, Hq, Hkv, Sq, Sk, d, key lengths per batch row)
ATTN_SHAPES = [
    (2, 4, 4, 16, 16, 16, (16, 16)),
    (2, 4, 2, 16, 16, 16, (16, 9)),
    (2, 4, 2, 8, 8, 16, (8, 0)),
    (3, 2, 1, 12, 12, 16, (12, 5, 1)),
    (8, 12, 12, 128, 128, 64, (128, 100, 77, 64, 31, 8, 0, 0)),
    (2, 12, 12, 512, 512, 64, (512, 300)),
    (1, 4, 2, 40, 72, 64, (70,)),
    (2, 4, 2, 16, 24, 18, (24, 10)),                 # d % 4, padded to 20
    (1, 4, 2, 40, 2048, 64, (2048,)),                # tiled: past smem
    (2, 2, 1, 33, 1500, 64, (1500, 700)),            # tiled, ragged tile
]


def _attn_case(dev, B, Hq, Hkv, Sq, Sk, d, lens):
    g = torch.Generator(device=dev).manual_seed(B * Sq + Sk + d)
    q = torch.randint(-128, 128, (B, Hq, Sq, d), generator=g, device=dev,
                      dtype=torch.int8)
    k = torch.randint(-128, 128, (B, Hkv, Sk, d), generator=g, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-128, 128, (B, Hkv, Sk, d), generator=g, device=dev,
                      dtype=torch.int8)
    idx = torch.arange(Sk, device=dev, dtype=torch.int32)
    k_pos = torch.where(idx[None] < torch.tensor(lens, device=dev)[:, None],
                        idx[None], -1).to(torch.int32)
    # scores of a few units; p_scale = amax / 255 with amax 0.6
    qs = torch.tensor(0.35 / d, device=dev)
    scales = dict(q_scale=qs, k_scale=torch.tensor(0.013, device=dev),
                  p_scale=torch.tensor(0.6, device=dev) / 255.0,
                  v_scale=torch.tensor(0.02, device=dev))
    return q, k, v, k_pos, scales


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_quant_flash_attention(dev, shape, requant, softcap):
    """Kernel against its plain version: int8 output within one code on at
    most 0.5% of elements, float output within rel-Linf 5e-3."""
    q, k, v, k_pos, kw = _attn_case(dev, *shape)
    if requant:
        kw["o_scale"] = torch.tensor(0.01, device=dev)
    before = flash_attention.launches
    out = flash_attention.quant_flash_attention(q, k, v, k_pos,
                                                softcap=softcap, **kw)
    assert flash_attention.launches == before + 1
    want = flash_attention.quant_flash_attention_plain(q, k, v, k_pos,
                                                       softcap=softcap, **kw)
    torch.cuda.synchronize()
    assert out.shape == want.shape == q.shape
    if requant:
        assert out.dtype == torch.int8
        diff = (out.int() - want.int()).abs()
        assert int(diff.max()) <= 1
        assert float((diff > 0).float().mean()) <= 5e-3
    else:
        assert torch.isfinite(out).all()
        assert _rel(want, out) <= 5e-3


def test_quant_flash_attention_takes_shared_k_pos(dev):
    """(Sk,) key positions broadcast over the batch, as (B, Sk) do."""
    q, k, v, k_pos, kw = _attn_case(dev, 2, 4, 2, 16, 16, 16, (16, 16))
    a = flash_attention.quant_flash_attention(q, k, v, k_pos[0], **kw)
    b = flash_attention.quant_flash_attention(q, k, v, k_pos, **kw)
    assert a.equal(b)


def test_quant_flash_attention_refuses(dev):
    q, k, v, k_pos, kw = _attn_case(dev, 2, 4, 2, 16, 16, 16, (16, 16))
    fa = flash_attention.quant_flash_attention
    with pytest.raises(ValueError):                     # not contiguous
        fa(q.transpose(2, 3), k, v, k_pos, **kw)
    with pytest.raises(TypeError):                      # float q
        fa(q.float(), k, v, k_pos, **kw)
    with pytest.raises(ValueError):                     # Hq % Hkv
        fa(q[:, :3].contiguous(), k, v, k_pos, **kw)
    with pytest.raises(ValueError):                     # k_pos size
        fa(q, k, v, k_pos[:, :5], **kw)
    with pytest.raises(ValueError):                     # k_pos on the CPU
        fa(q, k, v, k_pos.cpu(), **kw)


# head dims over 256 (the wide kernel): 260 (padded to 264 for its 4-byte
# rows), 320 and 512, with GQA, ragged and all-padding rows, a query count
# off the 4-row block, and 4096 keys at 320 (past the row-block kernel's
# shared memory, where the tensor-core kernels would take the long-key one)
WIDE_ATTN_SHAPES = [
    (2, 4, 2, 40, 77, 320, (77, 30)),
    (2, 2, 2, 9, 64, 512, (64, 0)),
    (1, 3, 1, 5, 33, 260, (20,)),
    (1, 2, 1, 8, 4096, 320, (4096,)),
]


@pytest.mark.parametrize("shape", WIDE_ATTN_SHAPES)
@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_quant_flash_attention_wide_head_dims(dev, shape, requant, softcap):
    """Head dims over 256 run the wide kernel, which keeps the plain
    version's order: equal bit for bit, float and int8 output."""
    q, k, v, k_pos, kw = _attn_case(dev, *shape)
    if requant:
        kw["o_scale"] = torch.tensor(0.01, device=dev)
    before = flash_attention.launches
    out = flash_attention.quant_flash_attention(q, k, v, k_pos,
                                                softcap=softcap, **kw)
    assert flash_attention.launches == before + 1
    want = flash_attention.quant_flash_attention_plain(q, k, v, k_pos,
                                                       softcap=softcap, **kw)
    torch.cuda.synchronize()
    assert out.shape == want.shape == q.shape
    assert out.equal(want), float((out.float() - want.float()).abs().max())


# bit-exact cases, no softcap: (B, Hq, Hkv, Sq, Sk, d, key lengths) at every
# BERT bucket (1, 8) .. (8, 128) and at 512 keys, with GQA, head dims 16 /
# 64 / 100 / 128, ragged lengths and an all-padding batch row; head dims 192
# and 256 (both run at 256) in the row-block kernel and, past its shared
# memory (512 keys at 256), in the long-key kernel
EXACT_SHAPES = [
    (1, 12, 12, 8, 8, 64, (8,)),
    (4, 12, 12, 16, 16, 64, (16, 11, 3, 0)),
    (4, 12, 12, 32, 32, 64, (32, 17, 32, 1)),
    (4, 12, 12, 64, 64, 64, (64, 40, 0, 63)),
    (8, 12, 12, 128, 128, 64, (128, 100, 77, 64, 31, 8, 0, 128)),
    (8, 12, 12, 512, 512, 64, (512, 300, 129, 64, 511, 1, 0, 257)),
    (2, 8, 4, 96, 96, 64, (96, 50)),                 # GQA g = 2
    (2, 4, 2, 40, 72, 16, (70, 0)),
    (2, 4, 2, 33, 130, 100, (130, 65)),
    (2, 4, 2, 70, 200, 128, (200, 199)),
    (2, 4, 2, 40, 96, 192, (96, 50)),
    (2, 4, 2, 40, 160, 256, (160, 0)),
    (1, 4, 2, 70, 700, 192, (700,)),                 # long-key kernel
    (2, 2, 1, 33, 800, 256, (800, 333)),             # long-key kernel
]


@pytest.mark.parametrize("shape", EXACT_SHAPES)
@pytest.mark.parametrize("requant", [False, True])
def test_quant_flash_attention_equals_plain(dev, shape, requant):
    """Without softcap the kernel returns the plain version's bits: the
    same int32 products, the same float32 softmax summed in the same
    order, the same codes and epilogue."""
    q, k, v, k_pos, kw = _attn_case(dev, *shape)
    # the two cases of 700 and 800 keys are the long-key kernel's
    assert flash_attention.quant_flash_attention_tiled(shape[4], shape[5]) \
        == (shape[4] >= 700)
    if requant:
        kw["o_scale"] = torch.tensor(0.01, device=dev)
    out = flash_attention.quant_flash_attention(q, k, v, k_pos, **kw)
    want = flash_attention.quant_flash_attention_plain(q, k, v, k_pos, **kw)
    torch.cuda.synchronize()
    assert out.dtype == want.dtype and out.equal(want)


@pytest.mark.parametrize("Sk,d,lens", [(512, 64, (512, 300)),
                                       (100, 16, (100, 3)),
                                       (600, 128, (600, 450)),
                                       (200, 192, (200, 77)),
                                       (300, 256, (300, 0))])
@pytest.mark.parametrize("requant", [False, True])
def test_quant_flash_attention_tiled_equals_resident(dev, Sk, d, lens,
                                                     requant):
    """The long-key kernel (three sweeps over streamed key tiles) returns
    what the row-block kernel returns, bit for bit, at shapes both take."""
    q, k, v, k_pos, kw = _attn_case(dev, 2, 4, 2, 40, Sk, d, lens)
    o_scale = torch.tensor(0.01, device=dev) if requant else None
    scales = [build.scalar("t", n, kw[n], dev)
              for n in ("q_scale", "k_scale", "p_scale", "v_scale")]
    fn = build.function("samp_quant_flash_attention",
                        (build.P,) * 11 + (build.I,) * 7
                        + (build.F, build.I, build.P))
    outs = []
    for tiled in (0, 1):
        out = torch.empty(q.shape, device=dev,
                          dtype=torch.int8 if requant else torch.float32)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
                *(t.data_ptr() for t in scales),
                o_scale.data_ptr() if requant else None,
                None if requant else out.data_ptr(),
                out.data_ptr() if requant else None,
                2, 4, 2, 40, Sk, d, 1, 5.0, tiled, build.stream(dev))
        build.check(rc, "samp_quant_flash_attention")
        outs.append(out)
    torch.cuda.synchronize()
    assert outs[0].equal(outs[1])


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


def _decode_case(dev, B, Hkv, g, hd, ps, pps, mode, seed=0):
    """Pages in a scrambled order with a hole, lengths from one token to
    every page, one slot of length 0."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    NP = B * pps + 3
    q = torch.randn((B, Hkv, g, hd), generator=gen, device=dev)
    k = torch.randint(-127, 128, (NP, ps, Hkv, hd), generator=gen,
                      device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, (NP, ps, Hkv, hd), generator=gen,
                      device=dev, dtype=torch.int8)
    perm = torch.randperm(NP, generator=gen, device=dev).to(torch.int32)
    table = perm[:B * pps].reshape(B, pps).contiguous()
    lengths = torch.randint(1, ps * pps + 1, (B,), generator=gen,
                            device=dev, dtype=torch.int32)
    lengths[0] = ps * pps
    lengths[-1] = 0
    if pps > 2:
        table[0, 1] = -1                    # a hole inside a live range
    idx = torch.arange(pps, device=dev)[None] * ps
    table = torch.where(idx < lengths[:, None].clamp(min=1), table,
                        -1).to(torch.int32).contiguous()
    if mode == "per_token":
        ks = torch.rand((NP, ps, Hkv), generator=gen, device=dev) * 0.04 \
            + 0.01
        vs = torch.rand((NP, ps, Hkv), generator=gen, device=dev) * 0.04 \
            + 0.01
    else:
        ks = torch.rand((Hkv,), generator=gen, device=dev) * 0.04 + 0.01
        vs = torch.rand((Hkv,), generator=gen, device=dev) * 0.04 + 0.01
    kw = dict(k_scale=ks, v_scale=vs, per_head=mode != "per_token",
              p_scale=(torch.tensor(0.9 / 255, device=dev)
                       if mode == "p_scale" else None))
    return (q, k, v, table, lengths), kw


DECODE_SHAPES = [(8, 2, 7, 64, 16, 8), (3, 2, 2, 16, 8, 3),
                 (8, 1, 7, 64, 16, 8),        # a qwen2 rank at tp 2
                 (4, 1, 4, 128, 32, 2), (5, 4, 1, 32, 4, 5),
                 (2, 2, 3, 64, 16, 1),
                 (2, 4, 2, 256, 16, 3),       # gemma2's head dim
                 (3, 1, 8, 256, 64, 2),       # paligemma's, pages of 64
                 (2, 2, 2, 64, 64, 3), (2, 1, 3, 32, 128, 2),
                 (2, 1, 48, 128, 16, 2),      # granite's group: 2 blocks
                 (3, 2, 40, 64, 16, 2),
                 (2, 2, 3, 80, 16, 3),        # padded to 128
                 (2, 2, 2, 256, 128, 2),      # gemma2's, pages of 128
                 (3, 1, 2, 18, 3, 4)]         # bytewise, pages of 3


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("mode", ["per_token", "per_head", "p_scale"])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_attention_matches_plain(dev, shape, mode, softcap):
    """The kernel sums in the plain version's order: equal bit for bit."""
    args, kw = _decode_case(dev, *shape, mode)
    before = decode_attention.launches
    out = decode_attention.decode_attention(*args, softcap=softcap, **kw)
    assert decode_attention.launches == before + 1
    want = decode_attention.decode_attention_plain(*args, softcap=softcap,
                                                   **kw)
    torch.cuda.synchronize()
    assert out.shape == want.shape == args[0].shape
    assert torch.isfinite(out).all()
    assert out.equal(want), float((out - want).abs().max())
    assert bool((out[-1] == 0).all())       # the slot of length 0


@pytest.mark.parametrize("mode", ["per_token", "p_scale"])
def test_decode_attention_skips_out_of_range_pages(dev, mode):
    """A page id at or past num_pages is skipped like -1, by the kernel and
    the plain version alike."""
    (q, k, v, table, lengths), kw = _decode_case(dev, 4, 2, 7, 64, 16, 3,
                                                 mode)
    table[1, 0] = k.shape[0]
    table[2, -1] = k.shape[0] + 5
    holes = torch.where(table >= k.shape[0], -1, table)
    out = decode_attention.decode_attention(q, k, v, table, lengths, **kw)
    want = decode_attention.decode_attention_plain(q, k, v, holes, lengths,
                                                   **kw)
    torch.cuda.synchronize()
    assert out.equal(want), float((out - want).abs().max())


# every built head dim and page size, with the group each head dim's
# models use; pages_per_slot 1, 2, 8 and 40 make 1, 2, 8 and 20 splits
# (one page a split up to 32 pages, then 2)
SPLIT_GROUPS = {16: 3, 32: 2, 64: 7, 128: 6, 256: 2}
SPLITS = {1: 1, 2: 2, 8: 8, 40: 20}


@pytest.mark.parametrize("hd", decode_attention.HEAD_DIMS)
@pytest.mark.parametrize("ps", decode_attention.PAGE_SIZES)
@pytest.mark.parametrize("pps", sorted(SPLITS))
@pytest.mark.parametrize("mode", ["per_token", "p_scale"])
def test_decode_attention_splits_equal_plain(dev, hd, ps, pps, mode):
    """Split over pages (flash-decoding), the kernel still sums in the
    plain version's order: equal bit for bit at 1, 2 and many splits, with
    empty splits past short slots, -1 holes and a slot of length 0."""
    assert decode_attention.block_rows(hd, ps, SPLIT_GROUPS[hd])
    args, kw = _decode_case(dev, 3, 2, SPLIT_GROUPS[hd], hd, ps, pps, mode,
                            seed=hd + ps + pps)
    assert decode_attention.decode_splits(
        pps, decode_attention.decode_split_pages(pps)) == SPLITS[pps]
    before = decode_attention.launches
    out = decode_attention.decode_attention(*args, **kw)
    assert decode_attention.launches == before + 1
    want = decode_attention.decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert out.equal(want), float((out - want).abs().max())
    assert bool((out[-1] == 0).all())       # the slot of length 0


def test_decode_attention_at_4096_tokens(dev):
    """The long context the split is for: 256 pages a slot, 32 splits of 8
    pages, equal to the plain version bit for bit in both modes."""
    for mode in ("per_token", "p_scale"):
        args, kw = _decode_case(dev, 8, 2, 7, 64, 16, 256, mode)
        args[4].fill_(4096)
        q, k, v, table, lengths = args
        table.copy_(torch.randperm(k.shape[0], device=dev)[:8 * 256]
                    .reshape(8, 256).to(torch.int32))
        out = decode_attention.decode_attention(*args, **kw)
        want = decode_attention.decode_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        assert out.equal(want), (mode, float((out - want).abs().max()))


# head dims over 256 (the wide kernel): 320, 512 and 300 (not a multiple
# of 32), pages of 16 and 128 and of 5 (not a power of two), 1, 3 and 20
# splits, groups of 1 to 8
WIDE_DECODE_SHAPES = [(3, 2, 2, 320, 16, 3), (2, 1, 8, 512, 16, 40),
                      (2, 2, 1, 512, 128, 2), (3, 1, 3, 300, 5, 4),
                      (2, 1, 2, 320, 128, 1)]


@pytest.mark.parametrize("shape", WIDE_DECODE_SHAPES)
@pytest.mark.parametrize("mode", ["per_token", "per_head", "p_scale"])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_attention_wide_head_dims(dev, shape, mode, softcap):
    """Head dims over 256 run the wide kernel, which keeps the plain
    version's orders (tree_sum over the head dim and the page, the splits'
    combine): equal bit for bit, and a slot of length 0 is zeros."""
    args, kw = _decode_case(dev, *shape, mode, seed=sum(shape))
    before = decode_attention.launches
    out = decode_attention.decode_attention(*args, softcap=softcap, **kw)
    assert decode_attention.launches == before + 1
    want = decode_attention.decode_attention_plain(*args, softcap=softcap,
                                                   **kw)
    torch.cuda.synchronize()
    assert out.shape == want.shape == args[0].shape
    assert torch.isfinite(out).all()
    assert out.equal(want), float((out - want).abs().max())
    assert bool((out[-1] == 0).all())


def test_decode_attention_refuses(dev):
    args, kw = _decode_case(dev, 2, 2, 2, 64, 16, 2, "per_token")
    q, k, v, table, lengths = args
    da = decode_attention.decode_attention
    with pytest.raises(TypeError):                      # float pages
        da(q, k.float(), v.float(), table, lengths, **kw)
    with pytest.raises(TypeError):                      # int64 table
        da(q, k, v, table.long(), lengths, **kw)
    with pytest.raises(ValueError):                     # scales' shape
        da(q, k, v, table, lengths, **dict(kw, per_head=True))
    with pytest.raises(ValueError):                     # table on the CPU
        da(q, k, v, table.cpu(), lengths, **kw)


def test_decode_engine_fused_equals_reference(dev):
    """Reduced qwen2 served greedily under int8 KV pages: the fused backend
    (the decode kernel and the GEMM kernels) gives the reference's tokens
    and logits exactly, and launches the decode kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("qwen2-0.5b").reduced()
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    plan = T.build_plan(cfg, fp)
    params = T.init_params(cfg, fp, seed=0, device=dev)
    outs, logits = [], []
    for backend in ("reference", "fused"):
        eng = ServeEngine(cfg, params, plan, batch_slots=2, max_len=64,
                          page_size=8, kv_cache="int8_per_token",
                          backend=backend, device=dev)
        seen = []
        step = eng._decode

        def record(*a, step=step, seen=seen):
            out, caches = step(*a)
            seen.append(out.clone())
            return out, caches
        eng._decode = record
        for i, p in enumerate([[2, 17, 9], [5, 40], [11, 3, 7, 1]]):
            eng.submit(Request(uid=i, prompt=p, max_tokens=6))
        kernels.reset_launches()
        outs.append({r.uid: r.output for r in eng.run()})
        logits.append(torch.stack(seen))
        assert eng.kv_pages_in_use == 0
    assert kernels.launch_counts()["decode_attention"] == \
        cfg.num_layers * len(logits[1])
    assert outs[0] == outs[1]
    assert logits[0].equal(logits[1])


# (G, E, C, D, F): decode's 3 rows per expert, ragged D and F, a capacity
# past one 64-row tile and across token groups, and a (4, 128) forward's
EXPERT_SHAPES = [(1, 8, 3, 256, 512), (1, 4, 1, 36, 70), (2, 3, 70, 1030, 65),
                 (2, 8, 5, 64, 128), (1, 8, 160, 512, 256)]


def _expert_case(dev, G, E, C, D, F, mode):
    g = torch.Generator(device=dev).manual_seed(G * C + D + F)
    xe = torch.randn((G, E, C, D), generator=g, device=dev) * 2.0
    wq = torch.randint(-127, 128, (E, D, F), generator=g, device=dev,
                       dtype=torch.int8)
    ws = torch.rand((E, 1, F), generator=g, device=dev) * 1e-3 + 1e-5
    amax = xe.abs().amax(dim=(0, 2, 3))
    xs = {"scalar": amax.max() / 127.0,
          "per_expert": (amax / 127.0).reshape(E, 1, 1),
          "per_token": None}[mode]
    return xe, wq, ws, xs


@pytest.mark.parametrize("shape", EXPERT_SHAPES)
@pytest.mark.parametrize("mode", ["scalar", "per_expert", "per_token"])
def test_quant_expert_gemm(dev, shape, mode):
    """One launch for every expert, bit for bit the plain version's output
    (int32 sums, the same epilogue order); per-token scales come from one
    dynamic_quant launch over the whole routed buffer."""
    xe, wq, ws, xs = _expert_case(dev, *shape, mode)
    kernels.reset_launches()
    y = expert_gemm.quant_expert_gemm(xe, wq, ws, xs)
    counts = kernels.launch_counts()
    assert counts["quant_expert_gemm"] == 1
    assert kernels.expert_gemm.per_token_launches == (xs is None)
    assert counts["dynamic_quant"] == (xs is None)
    want = expert_gemm.quant_expert_gemm_plain(xe, wq, ws, xs)
    assert y.dtype == torch.float32 and y.shape == want.shape
    assert y.equal(want)


@pytest.mark.parametrize("C", [1, 3, 8, 33, 160])
@pytest.mark.parametrize("D,F", [(256, 512), (100, 72), (1030, 65)])
@pytest.mark.parametrize("mode", ["per_expert", "per_token"])
def test_quant_expert_gemm_weight_stream(dev, C, D, F, mode):
    """E = 8 experts through the tensor-core stream (C <= 32, split over D
    where the column tiles are few) and the tiled kernel (C = 33, 160),
    ragged D and F: codes exact, output equal to the plain version."""
    xe, wq, ws, xs = _expert_case(dev, 1, 8, C, D, F, mode)
    y = expert_gemm.quant_expert_gemm(xe, wq, ws, xs)
    want = expert_gemm.quant_expert_gemm_plain(xe, wq, ws, xs)
    torch.cuda.synchronize()
    assert _rel(want, y) <= 1e-6
    assert y.equal(want)
    if mode == "per_token":            # the kernel's codes and scales
        from repro_torch.core.quantize import quantize_per_token
        q, sc = dynamic_quant.dynamic_quant(xe.reshape(-1, D))
        ref = quantize_per_token(xe)
        assert q.equal(ref.values.reshape(-1, D))
        assert sc.equal(ref.scale.reshape(-1, 1))


# the row-parallel expert stacks of a 2-way tensor-parallel mesh (wd's
# hidden units halved): mixtral-8x22b's 8 experts of 8192 of 16384 rows
# at decode's capacity 3 and a forward's 160, deepseek-v2's 160 of 768 of
# 1536 at capacity 1, and a ragged stack split over D; G = 2 groups too
EXPERT_ACC_SHAPES = [(1, 8, 3, 8192, 6144), (1, 8, 160, 8192, 6144),
                     (1, 160, 1, 768, 5120), (2, 4, 5, 1030, 72)]


@pytest.mark.parametrize("shape", EXPERT_ACC_SHAPES)
@pytest.mark.parametrize("mode", ["per_expert", "per_token"])
def test_quant_expert_gemm_accumulator_mode(dev, shape, mode):
    """The accumulator mode (one launch for the stack, counted as the
    kernel's) returns the exact int32 sums, its plain version's bit for
    bit; the two halves of D add to the whole; the epilogue after the sum
    equals the kernel's own output bit for bit, the per-token codes taken
    at the whole rows' scales (``dynamic_quant``'s scale-in mode)."""
    G, E, C, D, F = shape
    xe, wq, ws, xs = _expert_case(dev, G, E, C, D, F, mode)
    be = backend.FusedBackend()
    from repro_torch.core.quantize import QuantizedTensor
    w = QuantizedTensor(wq, ws, None)
    whole_amax = xe.abs().amax(dim=-1)
    kernels.reset_launches()
    acc, x_scale = be.expert_gemm_acc(
        xe, w, xs, row_amax=lambda a: torch.maximum(a, whole_amax))
    assert kernels.launch_counts()["quant_expert_gemm"] == 1
    assert expert_gemm.acc_launches == 1
    assert expert_gemm.per_token_launches == (xs is None)
    codes, _ = expert_gemm.expert_codes_plain(xe, E, xs)
    assert acc.dtype == torch.int32 and acc.equal(
        expert_gemm.quant_expert_gemm_acc(codes.cpu(), wq.cpu()).to(dev))
    h = D // 2
    halves = [be.expert_gemm_acc(
        xe[..., s].contiguous(),
        QuantizedTensor(wq[:, s].contiguous(), ws, None), xs,
        row_amax=lambda a: torch.maximum(a, whole_amax))
        for s in (slice(0, h), slice(h, None))]
    assert (halves[0][0] + halves[1][0]).equal(acc)
    assert halves[0][1].equal(x_scale)
    y = expert_gemm.quant_expert_gemm_epilogue(acc, ws, x_scale)
    assert y.equal(expert_gemm.quant_expert_gemm(xe, wq, ws, xs))


def test_quant_expert_gemm_splits_mirror_the_library(dev):
    fn = build.function("samp_quant_expert_gemm_splits", (build.I,) * 4)
    for rows in (1, 3, 8, 32, 33, 160):
        for D, F in ((6144, 16384), (16384, 6144), (1030, 65), (100, 72),
                     (256, 512)):
            for E in (1, 8):
                assert fn(rows, F, D, E) == \
                    quant_linear.quant_linear_splits(rows, F, D, E)


def test_quant_expert_gemm_takes_three_dims_and_shared_scales(dev):
    """An (E, C, D) buffer without the group axis, and weight scales that
    broadcast to (E, 1, F) from one per-tensor value."""
    xe, wq, ws, xs = _expert_case(dev, 1, 4, 3, 64, 32, "per_expert")
    one = torch.full((1, 1, 1), 1e-3, device=dev)
    y = expert_gemm.quant_expert_gemm(xe[0], wq, one, xs)
    assert y.shape == (4, 3, 32)
    assert y.equal(expert_gemm.quant_expert_gemm_plain(xe[0], wq, one, xs))


def test_quant_expert_gemm_refuses(dev):
    xe, wq, ws, xs = _expert_case(dev, 1, 4, 3, 64, 32, "per_expert")
    qeg = expert_gemm.quant_expert_gemm
    with pytest.raises(TypeError):                      # float weights
        qeg(xe, wq.float(), ws, xs)
    with pytest.raises(TypeError):                      # float64 buffer
        qeg(xe.double(), wq, ws, xs)
    with pytest.raises(ValueError):                     # 3 experts routed
        qeg(xe[:, :3].contiguous(), wq, ws, xs)
    with pytest.raises(ValueError):                     # D mismatch
        qeg(xe[..., :32].contiguous(), wq, ws, xs)
    with pytest.raises(ValueError):                     # not contiguous
        qeg(xe.transpose(2, 3).contiguous().transpose(2, 3), wq, ws, xs)
    with pytest.raises(ValueError):                     # weights on the CPU
        qeg(xe, wq.cpu(), ws, xs)
    with pytest.raises(ValueError):                     # scales on the CPU
        qeg(xe, wq, ws.cpu(), xs)
    with pytest.raises(ValueError):                     # 3 scales for 4
        qeg(xe, wq, ws, xs[:3])
    with pytest.raises(ValueError):                     # no (E, D, F) stack
        qeg(xe, wq[0], ws, xs)


def test_moe_engine_fused_equals_reference(dev):
    """Reduced mixtral under the golden v4 plan, calibrated and quantized
    on the card and served greedily: the fused backend (the expert GEMM,
    quant_linear and dynamic_quant kernels) gives the reference's tokens and
    logits exactly, with 9 expert GEMM launches a tick (3 per-token)."""
    from pathlib import Path
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import synthetic_calibration_batches
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T
    from repro_torch.quant import ptq
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("mixtral-8x22b").reduced()
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    float_plan = T.build_plan(cfg, fp)
    params = T.init_params(cfg, fp, seed=0, device=dev)
    plan = PrecisionPlan.load(str(Path(__file__).resolve().parent / "data"
                                  / "golden_plan_v4.json"))
    batches = synthetic_calibration_batches(cfg, num_batches=2, batch_size=4,
                                            seq_len=16)
    stats = ptq.capture_stats(params, batches, cfg, float_plan,
                              precision=plan)
    q, qplan = ptq.apply_plan(params, cfg, plan, stats,
                              float_plan=float_plan)
    outs, logits = [], []
    for backend in ("reference", "fused"):
        eng = ServeEngine(cfg, q, qplan, batch_slots=4, max_len=32,
                          backend=backend, precision=plan, device=dev)
        seen = []
        step = eng._decode

        def record(*a, step=step, seen=seen):
            out, caches = step(*a)
            seen.append(out.clone())
            return out, caches
        eng._decode = record
        for i, p in enumerate([[2, 17, 9], [5, 40], [11, 3, 7, 1], [9],
                               [23, 8, 1]]):
            eng.submit(Request(uid=i, prompt=p, max_tokens=6))
        kernels.reset_launches()
        outs.append({r.uid: r.output for r in eng.run()})
        logits.append(torch.stack(seen))
        assert eng.kv_pages_in_use == 0
    ticks = len(logits[1])
    assert kernels.launch_counts()["quant_expert_gemm"] == 9 * ticks
    assert kernels.expert_gemm.per_token_launches == 3 * ticks
    assert outs[0] == outs[1]
    assert logits[0].equal(logits[1])


# ---------------------------------------------------------------------------
# float flash attention
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Sk, d, bq, bk): every instantiated head dim, one padded
# (48 -> 64), logical blocks unlike the kernel's tiles, Sq != Sk, GQA
FLOAT_ATTN_SHAPES = [
    (2, 4, 2, 128, 256, 16, 64, 64),
    (1, 4, 1, 96, 96, 32, 32, 32),
    (2, 4, 4, 256, 256, 64, 64, 64),
    (1, 2, 1, 80, 80, 48, 80, 80),
    (1, 3, 1, 200, 200, 128, 40, 100),
    (1, 2, 2, 64, 128, 256, 64, 64),
]
FLOAT_MASKS = {"none": {}, "causal": dict(causal=True),
               "window": dict(causal=True, window=40),
               "softcap": dict(causal=True, softcap=30.0),
               "window_only": dict(window=16)}
# float32 output within 2e-4 of the plain version (the JAX test's budget);
# a 16-bit output is each side's float32 result rounded once, so two
# results within 2e-4 may round one unit of the last place apart
ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
       torch.float16: 2.0 ** -11}


def _float_attn_case(dev, B, Hq, Hkv, Sq, Sk, d, dtype):
    g = torch.Generator(device=dev).manual_seed(B * Sq + Sk + d)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((B, Hq, Sq, d), (B, Hkv, Sk, d),
                               (B, Hkv, Sk, d)))


def assert_float_attention_close(out, q, k, v, **kw):
    """The kernel's output against the plain version run on the same
    inputs in float32 (exact for 16-bit inputs, and the plain version's
    float32 result before its cast)."""
    want = flash_attention.flash_attention_plain(q.float(), k.float(),
                                                 v.float(), **kw)
    err = (out.float() - want).abs()
    bound = 2e-4 + (2e-4 + ULP[q.dtype]) * want.abs()
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("shape", FLOAT_ATTN_SHAPES)
@pytest.mark.parametrize("mask", sorted(FLOAT_MASKS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_matches_plain(dev, shape, mask, dtype):
    B, Hq, Hkv, Sq, Sk, d, bq, bk = shape
    q, k, v = _float_attn_case(dev, B, Hq, Hkv, Sq, Sk, d, dtype)
    kw = dict(FLOAT_MASKS[mask], bq=bq, bk=bk)
    before = flash_attention.float_launches
    out = ops.flash_attention(q, k, v, **kw)
    assert flash_attention.float_launches == before + 1
    torch.cuda.synchronize()
    assert_float_attention_close(out, q, k, v, **kw)


def test_flash_attention_rows_without_a_valid_key(dev):
    """A window without causal and more queries than keys: rows whose
    blocks do not run return 0, rows whose run blocks hold no valid key the
    mean of those keys' values, as the JAX kernel does (never NaN)."""
    q, k, v = _float_attn_case(dev, 1, 2, 2, 256, 64, 64, torch.float32)
    kw = dict(window=16, bq=32, bk=32)
    out = flash_attention.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_float_attention_close(out, q, k, v, **kw)
    assert bool((out[:, :, 96:] == 0).all())
    assert torch.allclose(out[:, :, 80:96],
                          v[:, :, 32:64].mean(dim=2, keepdim=True)
                          .expand(-1, -1, 16, -1), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("mask", ["causal", "window"])
def test_flash_attention_head_dim_256(dev, dtype, mask):
    q, k, v = _float_attn_case(dev, 1, 4, 2, 320, 320, 256, dtype)
    kw = dict(FLOAT_MASKS[mask], bq=64, bk=64)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_float_attention_close(out, q, k, v, **kw)


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("mask", ["none", "window", "softcap"])
def test_flash_attention_wide_head_dims(dev, d, dtype, mask):
    """Head dims over 256 run the wide kernel: within the float kernel's
    budget of the plain version, GQA, blocks that differ from its tiles."""
    q, k, v = _float_attn_case(dev, 1, 4, 2, 192, 192, d, dtype)
    kw = dict(FLOAT_MASKS[mask], bq=64, bk=48)
    before = flash_attention.float_launches
    out = ops.flash_attention(q, k, v, **kw)
    assert flash_attention.float_launches == before + 1
    torch.cuda.synchronize()
    assert_float_attention_close(out, q, k, v, **kw)


def test_flash_attention_long_window_bfloat16(dev):
    """4096 keys under a 1024-key causal window, 512-key logical blocks."""
    q, k, v = _float_attn_case(dev, 1, 4, 1, 4096, 4096, 64, torch.bfloat16)
    kw = dict(causal=True, window=1024, bq=512, bk=512)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_float_attention_close(out, q, k, v, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_rows_that_cancel(dev, dtype, causal):
    """Keys in pairs with nearly equal scores and opposite values: every
    output cancels near 0, so the budget is the absolute 2e-4, which one
    16-bit rounding of P (2^-9 of sum p |v| / l) would break."""
    g = torch.Generator(device=dev).manual_seed(21)
    B, H, S, d = 1, 2, 256, 64
    q = torch.randn((B, H, S, d), generator=g, device=dev)
    k = torch.randn((B, H, S, d), generator=g, device=dev)
    k[:, :, 1::2] = k[:, :, 0::2] + 0.01 * torch.randn(
        (B, H, S // 2, d), generator=g, device=dev)
    v = 4.0 * torch.randn((B, H, S, d), generator=g, device=dev)
    v[:, :, 1::2] = -v[:, :, 0::2]
    q, k, v = (t.to(dtype) for t in (q, k, v))
    kw = dict(causal=causal, bq=64, bk=64)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    rows = slice(1, None, 2) if causal else slice(None)
    assert float(out.float()[:, :, rows].abs().mean()) < 0.05
    assert_float_attention_close(out, q, k, v, **kw)


def test_flash_attention_smem_of_each_dtype_mirrors_the_library(dev):
    fn = build.function("samp_flash_attention_smem_of", (build.I, build.I),
                        ctypes.c_longlong)
    for code, dtype in ((0, torch.float32), (1, torch.bfloat16),
                        (2, torch.float16)):
        for d in (1, 16, 17, 48, 64, 100, 128, 200, 256):
            assert fn(d, code) == flash_attention.flash_attention_smem(
                d, dtype)


def test_flash_attention_smem_mirrors_the_library(dev):
    fn = build.function("samp_flash_attention_smem", (build.I,),
                        ctypes.c_longlong)
    for d in (1, 16, 17, 48, 64, 100, 128, 200, 256):
        assert fn(d) == flash_attention.flash_attention_smem(d)
    qfn = build.function("samp_quant_flash_attention_smem",
                         (build.I, build.I), ctypes.c_longlong)
    for Sk, d in ((16, 16), (128, 64), (512, 64), (1344, 64), (1345, 64),
                  (2048, 64), (300, 128), (130, 100), (64, 256), (8, 320)):
        assert qfn(Sk, d) == flash_attention.quant_flash_attention_smem(Sk, d)
    dfn = build.function("samp_decode_attention_smem",
                         (build.I, build.I, build.I), ctypes.c_longlong)
    for rows, hd, ps in ((7, 64, 16), (1, 18, 3), (24, 128, 128),
                         (32, 256, 64), (1, 256, 128), (32, 256, 128),
                         (4, 320, 16)):
        assert dfn(rows, hd, ps) == decode_attention.decode_attention_smem(
            rows, hd, ps)


@pytest.mark.parametrize("group",
                         sorted({1, 2, 7, 32, *SPLIT_GROUPS.values()}))
def test_decode_attention_256_128_fits_a_block(dev, group):
    """Head dim 256 with pages of 128 tokens: K and V share one page
    buffer, so the block the wrapper picks for any group is within the
    card's opt-in shared memory, and the kernel launches there."""
    rows = decode_attention.block_rows(256, 128, group)
    assert 0 < rows <= decode_attention.MAX_BLOCK_ROWS
    dfn = build.function("samp_decode_attention_smem",
                         (build.I, build.I, build.I), ctypes.c_longlong)
    smem = dfn(rows, 256, 128)
    assert smem == decode_attention.decode_attention_smem(rows, 256, 128)
    assert 0 < smem <= decode_attention._MAX_SMEM
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert smem <= limit
    assert decode_attention.kv_buffers(256, 128) == 1
    args, kw = _decode_case(dev, 2, 1, group, 256, 128, 2, "per_token")
    out = decode_attention.decode_attention(*args, **kw)
    want = decode_attention.decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert out.equal(want), float((out - want).abs().max())


def test_flash_attention_refuses(dev):
    q, k, v = _float_attn_case(dev, 1, 4, 2, 64, 64, 64, torch.float32)
    fa = flash_attention.flash_attention
    with pytest.raises(ValueError):                     # dtype
        fa(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):                      # mixed dtypes
        fa(q, k.half(), v.half())
    with pytest.raises(ValueError):                     # blocks
        fa(q, k, v, bq=48)
    with pytest.raises(ValueError):                     # Hq % Hkv
        fa(q[:, :3].contiguous(), k, v)
    with pytest.raises(ValueError):                     # not contiguous
        fa(q.transpose(2, 3), k, v)


# ---------------------------------------------------------------------------
# the fused backend at the shapes the kernels once refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2, 2, 256, 16, 2),
                                   (2, 2, 2, 64, 64, 2),
                                   (1, 1, 40, 64, 16, 1)])
def test_fused_paged_decode_launches_every_shape(dev, shape):
    """Head dim 256, page size 64, a GQA group of 40: the fused backend
    launches the kernel, which equals the plain version the reference
    backend runs."""
    args, kw = _decode_case(dev, *shape, "per_token")
    q, k, v, table, lengths = args
    ops_ = dict(q=q, k_pages=k, v_pages=v, page_table=table,
                lengths=lengths, **kw)
    kernels.reset_launches()
    out = backend.FusedBackend().paged_decode(**ops_)
    want = backend.ComputeBackend().paged_decode(**ops_)
    assert out.equal(want)
    assert kernels.launch_counts()["decode_attention"] == 1


def test_fused_attention_launches_past_shared_memory(dev):
    """Sk = 2048 at d = 64 is past the resident kernel's shared memory: the
    fused backend claims the core all the same and launches the tiled
    kernel, as it launches the resident one at Sk = 512."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=dev).manual_seed(0)
    p = {"q_scale": torch.tensor(0.01, device=dev),
         "k_scale": torch.tensor(0.03, device=dev),
         "p_scale": torch.tensor(0.4 / 255, device=dev),
         "v_scale": torch.tensor(0.03, device=dev)}
    for Sk in (2048, 512):
        q, k, v = (torch.randn((1, Sk, 2, 64), generator=g, device=dev)
                   for _ in range(3))
        pos = torch.arange(Sk, device=dev, dtype=torch.int32)
        kernels.reset_launches()
        out = backend.FusedBackend().attention(
            q, k, v, p, k_pos=pos, spec=L.MaskSpec(causal=False),
            scale=0.125)
        assert backend.ComputeBackend().attention(
            q, k, v, p, k_pos=pos, spec=L.MaskSpec(causal=False),
            scale=0.125) is None
        assert out.shape == (1, Sk, 2, 64) and torch.isfinite(out).all()
        assert kernels.launch_counts()["quant_flash_attention"] == 1


@pytest.mark.parametrize("page_size,head_dim", [(64, None), (16, 256),
                                                (128, 256)])
def test_decode_engine_unbuilt_shapes_equal_reference(dev, page_size,
                                                      head_dim):
    """Reduced qwen2 over int8 pages of 64 tokens, or at gemma2's head dim
    256: fused serves through the kernel, one launch a layer and tick,
    with the reference's tokens and logits."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("qwen2-0.5b").reduced()
    if head_dim:
        cfg = cfg.replace(head_dim=head_dim)
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    plan = T.build_plan(cfg, fp)
    params = T.init_params(cfg, fp, seed=0, device=dev)
    outs, logits = [], []
    for name in ("reference", "fused"):
        eng = ServeEngine(cfg, params, plan, batch_slots=2, max_len=128,
                          page_size=page_size, kv_cache="int8_per_token",
                          backend=name, device=dev)
        seen = []
        step = eng._decode

        def record(*a, step=step, seen=seen):
            out, caches = step(*a)
            seen.append(out.clone())
            return out, caches
        eng._decode = record
        for i, pr in enumerate([[2, 17, 9], [5, 40], [11, 3, 7, 1]]):
            eng.submit(Request(uid=i, prompt=pr, max_tokens=6))
        kernels.reset_launches()
        outs.append({r.uid: r.output for r in eng.run()})
        logits.append(torch.stack(seen))
    assert kernels.launch_counts()["decode_attention"] == \
        cfg.num_layers * len(logits[1])
    assert outs[0] == outs[1]
    assert logits[0].equal(logits[1])


def test_wallclock_times_the_fused_kernels(dev):
    """The wallclock latency backend, bound to the fused backend, times a
    quantized forward on the card: a positive median, and the forwards it
    ran launched the kernels."""
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import synthetic_calibration_batches
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.core.precision import LayerMode
    from repro_torch.models import transformer as T
    from repro_torch.quant import ptq
    from repro_torch.toolkit.latency import WallclockBackend
    cfg = get_config("bert-base").reduced()
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    params = T.init_params(cfg, fp, seed=0, device=dev)
    plan = PrecisionPlan.prefix(cfg.num_layers, cfg.num_layers,
                                LayerMode.QUANT_FFN_ONLY, "float32")
    stats = ptq.capture_stats(params, synthetic_calibration_batches(
        cfg, num_batches=1, seq_len=16), cfg, T.build_plan(cfg, fp))
    qparams, qplan = ptq.apply_plan(params, cfg, plan, stats)
    wall = WallclockBackend(reps=3, warmup=1)
    fn = wall.bind(cfg, batch=4, seq=16, backend="fused", device=dev)
    kernels.reset_launches()
    t = fn(qparams, qplan, plan)
    assert t > 0 and t == wall.samples[plan.fingerprint()][1]
    counts = kernels.launch_counts()
    assert counts["quant_linear"] == 4 * 2 * cfg.num_layers
    assert counts["fused_embed"] == 4
    assert counts["addnorm_quant"] == 4 * cfg.num_layers


def test_the_port_imports_no_jax(dev):
    """The card's machine has no JAX: the port's modules and this file's
    imports load neither ``jax`` nor the JAX package ``repro``."""
    import os
    import subprocess
    import sys
    code = ("import sys, torch, repro_torch.kernels, repro_torch.serve, "
            "repro_torch.toolkit, repro_torch.models.transformer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    src = Path(__file__).resolve().parents[1] / "src"
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ,
                                             PYTHONPATH=str(src)))
    assert run.returncode == 0, run.stdout + run.stderr


def test_routed_fused_encoder_equals_the_solo_member(dev):
    """Reduced BERT routed by length over two member plans on the fused
    backend (the ffn policy, and the whole-layer int8 span, which runs
    quant_flash_attention): each response bit-equal to an unrouted engine
    running its cluster's entry alone at the same bucket, one cached
    callable per (cluster, bucket), and the span's kernel launched."""
    import numpy as np
    from repro_torch.adaptive import (LengthBuckets, PlanSet,
                                      batch_clusters, build_router,
                                      clustered_synthetic_batches)
    from repro_torch.configs import get_config
    from repro_torch.core.plan import plan_from_policy
    from repro_torch.core.precision import make_policy
    from repro_torch.core.samp import SAMPEngine, int8_dataflow_variant
    from repro_torch.models import transformer as T
    from repro_torch.serve import EncoderRequest, EncoderServeEngine
    cfg = get_config("bert-base").reduced().replace(num_layers=2)
    eng = SAMPEngine(cfg, float_dtype="float32")
    params = T.init_params(cfg, eng.float_precision, seed=0,
                           head=("cls", 15), device=dev)
    model = LengthBuckets((8,))
    batches, classes = clustered_synthetic_batches(cfg, model, max_len=16,
                                                   batch_size=3)
    stats = eng.calibrate(params, batches, clusters=batch_clusters(
        model, batches, batch_classes=classes))
    ffn = plan_from_policy(make_policy(cfg, "ffn"))
    span = int8_dataflow_variant(plan_from_policy(make_policy(cfg, "full")))
    router = build_router(cfg, params, PlanSet(((0, ffn), (1, span))),
                          stats, cluster_model=model,
                          float_plan=eng.float_plan, backend="fused")
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in (5, 7, 12, 14)]
    e0 = router.entry(0)
    routed = EncoderServeEngine(cfg, e0.params, e0.plan, backend="fused",
                                max_batch=2, max_len=16, router=router,
                                device=dev)
    for i, toks in enumerate(reqs):
        routed.submit(EncoderRequest(uid=i, tokens=toks))
    kernels.reset_launches()
    done = {r.uid: r for r in routed.run()}
    launches = kernels.launch_counts()
    assert [done[i].cluster for i in range(4)] == [0, 0, 1, 1]
    assert launches["quant_flash_attention"] > 0
    assert launches["quant_linear"] > 0 and launches["fused_embed"] == 2
    assert routed.stats["runtime_executables"] == 2
    for c in (0, 1):
        e = router.entry(c)
        solo = EncoderServeEngine(cfg, e.params, e.plan, backend="fused",
                                  max_batch=2, max_len=16, device=dev)
        uids = [i for i in range(4) if done[i].cluster == c]
        for i in uids:
            solo.submit(EncoderRequest(uid=i, tokens=reqs[i]))
        for r in solo.run():
            np.testing.assert_array_equal(r.logits, done[r.uid].logits)


# ---------------------------------------------------------------------------
# the shapes the attention archs serve (chip_smoke.py's gemma2, granite,
# deepseek-coder, paligemma, hubert and deepseek-v2 paths)
# ---------------------------------------------------------------------------

# (slots, KV heads, group, head dim, page size, pages a slot, softcap)
SERVED_DECODE = {
    "granite_group48": (8, 1, 48, 128, 16, 8, None),
    "deepseek_coder_group7": (8, 8, 7, 128, 16, 8, None),
    "gemma2_hd256_pages128": (8, 4, 2, 256, 128, 1, 50.0),
    "paligemma_group8_hd256": (8, 1, 8, 256, 16, 8, None),
}


@pytest.mark.parametrize("name", sorted(SERVED_DECODE))
@pytest.mark.parametrize("mode", ["per_token", "per_head", "p_scale"])
def test_decode_attention_at_the_served_archs(dev, name, mode):
    """The decode kernel at each arch's served geometry: granite's MQA
    group of 48 (two blocks of 24 rows), deepseek-coder's group of 7,
    gemma2's head dim 256 over pages of 128 with softcap 50 and
    paligemma's group of 8 at head dim 256: one launch, the fused backend's
    result bit for bit the plain version the reference backend runs."""
    B, Hkv, g, hd, ps, pps, softcap = SERVED_DECODE[name]
    args, kw = _decode_case(dev, B, Hkv, g, hd, ps, pps, mode)
    if g > decode_attention.MAX_BLOCK_ROWS:
        assert decode_attention.block_rows(hd, ps, g) == -(-g // 2)
    q, k, v, table, lengths = args
    ops_ = dict(q=q, k_pages=k, v_pages=v, page_table=table,
                lengths=lengths, softcap=softcap, **kw)
    kernels.reset_launches()
    out = backend.FusedBackend().paged_decode(**ops_)
    assert kernels.launch_counts()["decode_attention"] == 1
    want = backend.ComputeBackend().paged_decode(**ops_)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert out.equal(want), float((out - want).abs().max())


@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("lens", [(128, 93, 16, 57, 128, 40, 111, 77),
                                  (16, 1, 9, 16, 0, 3, 12, 5)])
def test_quant_flash_attention_at_head_dim_80(dev, requant, lens):
    """hubert-xlarge's bidirectional span attention: 16 heads of 80 (run
    padded to 128), a batch of 8 frame sequences of up to 128 (and up to
    16) positions: equal to the plain version bit for bit, float and int8
    out."""
    Sk = max(lens)
    q, k, v, k_pos, kw = _attn_case(dev, 8, 16, 16, Sk, Sk, 80, lens)
    if requant:
        kw["o_scale"] = torch.tensor(0.01, device=dev)
    kernels.reset_launches()
    out = flash_attention.quant_flash_attention(q, k, v, k_pos, **kw)
    assert kernels.launch_counts()["quant_flash_attention"] == 1
    want = flash_attention.quant_flash_attention_plain(q, k, v, k_pos, **kw)
    torch.cuda.synchronize()
    assert out.dtype == want.dtype and out.equal(want)


@pytest.mark.parametrize("C", [1, 24])
@pytest.mark.parametrize("D,F", [(5120, 1536), (1536, 5120)])
@pytest.mark.parametrize("mode", ["per_expert", "per_token"])
def test_quant_expert_gemm_at_160_experts(dev, C, D, F, mode):
    """deepseek-v2's routed stacks at full width: 160 experts, at a decode
    tick's capacity (8 slots, top 6: C = 1) and a 4 x 128 forward's (C =
    24): one launch, equal to the plain version bit for bit."""
    xe, wq, ws, xs = _expert_case(dev, 1, 160, C, D, F, mode)
    kernels.reset_launches()
    y = expert_gemm.quant_expert_gemm(xe, wq, ws, xs)
    assert kernels.launch_counts()["quant_expert_gemm"] == 1
    want = expert_gemm.quant_expert_gemm_plain(xe, wq, ws, xs)
    torch.cuda.synchronize()
    assert y.shape == (1, 160, C, F) and y.equal(want)
