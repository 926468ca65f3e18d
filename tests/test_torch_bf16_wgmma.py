"""The bf16 LoRA kernels' choice between their two tiles, and the wgmma tile.

``lora_matmul`` and ``grouped_lora`` (chunk mode) run bf16 on the ``wgmma``
tile fed by TMA (``csrc/bf16_wgmma_tile.cuh``) where ``tma_ok`` holds, a
function of the operands' shapes, strides and pointers decided before the
launch, and on the ``mma.sync`` tile (``csrc/bf16_lora_tile.cuh``)
otherwise.  On the CPU these tests hold the choice on a table of cases:
every adapted projection of gemma-2b and rwkv6-3b, forward and in the dx
call's three views, takes the new tile; K 130, N 770, r 5 on the B^T view
and unaligned slices do not; and the edges of each condition.  The tests
named ``cuda`` (skipped here) hold the new tile against the plain version
on the card, each output row's relative error within 1e-2 (both sides sum
bf16 products in f32 and round y to bf16 once: rows differ by single-ulp
roundings, 2**-8 of an element, and a fault in indexing or masking is
O(1)).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.kernels import build
from repro_torch.kernels.grouped_lora import grouped_lora, grouped_lora_chunk
from repro_torch.kernels.lora_matmul import a_mode, lora_matmul, tma_ok
from repro_torch.kernels.ops import fused_lora_matmul, grouped_lora_matmul
from repro_torch.kernels.ref import grouped_lora_matmul_ref, lora_matmul_ref

BF16 = torch.bfloat16
R = 16
# (K, N) of every adapted projection: gemma-2b's q/o and k/v (MQA, one
# 256-wide head), rwkv6-3b's time-mix r/k/v/g/o and channel-mix r, its
# channel-mix k and v
LM_PROJECTIONS = {"gemma-2b q/o": (2048, 2048), "gemma-2b k/v": (2048, 256),
                  "rwkv6-3b 2560x2560": (2560, 2560), "rwkv6-3b cm k": (2560, 8960),
                  "rwkv6-3b cm v": (8960, 2560)}


def _operands(m, k, n, r, groups=None, dtype=BF16, dev="cpu"):
    """Uninitialized operands (only their layout matters to tma_ok)."""
    lead = () if groups is None else (groups,)
    return tuple(torch.empty(*s, dtype=dtype, device=dev)
                 for s in ((m, k), (k, n), lead + (r, k), lead + (n, r)))


def _dx_call(g, w, a, b):
    """The dx call's operands: (g, W^T, B^T, A^T) as views, as the
    autograd ops pass them."""
    if a.dim() == 3:
        return g, w.t(), b.transpose(1, 2), a.transpose(1, 2)
    return g, w.t(), b.t(), a.t()


@pytest.mark.parametrize("grouped", [False, True], ids=["lora_matmul", "grouped"])
@pytest.mark.parametrize("call", ["forward", "dx_call"])
@pytest.mark.parametrize("proj", list(LM_PROJECTIONS))
def test_every_lm_projection_takes_the_wgmma_tile(proj, call, grouped):
    k, n = LM_PROJECTIONS[proj]
    x, w, a, b = _operands(16, k, n, R, groups=2 if grouped else None)
    ops = (x, w, a, b) if call == "forward" else _dx_call(torch.empty(16, n, dtype=BF16),
                                                            w, a, b)
    assert tma_ok(*ops)
    # the forward's A by TMA; the dx call's A' = B^T (ranks contiguous) by
    # the producer's 16-byte loads
    assert a_mode(ops[2]) == (0 if call == "forward" else 1)


def _unaligned(*shape, dev="cpu"):
    """A contiguous bf16 tensor whose storage starts one element (2 bytes)
    past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.empty(n + 8, dtype=BF16, device=dev)[1:1 + n].view(shape)


CASES_TAKING_MMA_SYNC = {
    # x's rows are 260 bytes: no TMA stride
    "K 130": lambda dev: _operands(37, 130, 64, R, dev=dev),
    # W's rows are 1540 bytes
    "N 770": lambda dev: _operands(64, 768, 770, R, dev=dev),
    # the dx call's A' = B^T view at r 5: ranks contiguous in 10-byte runs
    "r 5 on the B^T view": lambda dev: _dx_call(*_operands(64, 256, 256, 5, dev=dev)),
    "unaligned x": lambda dev: (_unaligned(64, 256, dev=dev),
                                *_operands(64, 256, 256, R, dev=dev)[1:]),
    "unaligned W": lambda dev: (torch.empty(64, 256, dtype=BF16, device=dev),
                                _unaligned(256, 256, dev=dev),
                                *_operands(64, 256, 256, R, dev=dev)[2:]),
    "unaligned A": lambda dev: (*_operands(64, 256, 256, R, dev=dev)[:2],
                                _unaligned(R, 256, dev=dev),
                                torch.empty(256, R, dtype=BF16, device=dev)),
    "float32": lambda dev: _operands(64, 256, 256, R, dtype=torch.float32, dev=dev),
}


@pytest.mark.parametrize("case", list(CASES_TAKING_MMA_SYNC))
def test_what_tma_cannot_describe_takes_the_mma_sync_tile(case):
    assert not tma_ok(*CASES_TAKING_MMA_SYNC[case]("cpu"))


@pytest.mark.parametrize("case,expected", [
    ("K 8", True), ("K 4", False), ("K 136", True), ("K 132", False),
    ("W rows of 8", True), ("W rows of 12", False),
    ("B^T view r 8", True), ("B^T view r 12", False), ("B^T view r 24", True),
    ("A view r 5", False),
    ("x 8 elements in", True), ("x 4 elements in", False),
    ("group stride 8", True), ("group stride 4", False),
])
def test_tma_ok_at_the_edges(case, expected):
    """Each condition of tma_ok just inside and just outside its edge."""
    if case.startswith("K "):
        ops = _operands(16, int(case[2:]), 64, R)
    elif case.startswith("W rows of"):
        ops = _operands(16, 64, int(case.split()[-1]), R)
    elif case.startswith("B^T view r"):
        r = int(case.split()[-1])
        ops = _dx_call(torch.empty(16, 64, dtype=BF16), *_operands(16, 64, 64, r)[1:])
    elif case == "A view r 5":
        # A stored K-major neither way: the (r, K) view of a (K, r) tensor
        x, w, _, b = _operands(16, 64, 64, 5)
        ops = (x, w, torch.empty(64, 5, dtype=BF16).t(), b)
    elif case.startswith("x "):
        off = int(case.split()[1])
        buf = torch.empty(16 * 64 + off, dtype=BF16)
        ops = (buf[off:].view(16, 64), *_operands(16, 64, 64, R)[1:])
    else:
        # a stack of A_g whose group stride is 8 or 4 elements past r * K
        pad = int(case.split()[-1])
        buf = torch.empty(2, R * 64 + pad, dtype=BF16)
        a = buf[:, :R * 64].view(2, R, 64)
        ops = (*_operands(16, 64, 64, R)[:2], a, torch.empty(2, 64, R, dtype=BF16))
    assert tma_ok(*ops) is expected


def test_cpu_moves_no_counter():
    """On the CPU the plain version runs, at shapes the wgmma tile takes,
    and none of the three counters of either wrapper moves."""
    rs = np.random.default_rng(0)
    x, w, a, b = (torch.from_numpy(rs.standard_normal(s).astype(np.float32)).to(BF16)
                  for s in ((32, 64), (64, 64), (R, 64), (64, R)))
    assert tma_ok(x, w, a, b) and tma_ok(*_dx_call(x, w, a, b))
    counters = ((lora_matmul, "launches"), (lora_matmul, "launches_bf16"),
                (lora_matmul, "launches_wgmma"), (grouped_lora_chunk, "launches"),
                (grouped_lora_chunk, "launches_bf16"), (grouped_lora_chunk, "launches_wgmma"))
    before = [getattr(fn, attr) for fn, attr in counters]
    y = lora_matmul(x, w, a, b, scale=2.0)
    assert torch.equal(y, lora_matmul_ref(x, w, a, b, 2.0))
    a2, b2 = torch.stack([a, a]), torch.stack([b, b])
    yg = grouped_lora(x, w, a2, b2, group_sizes=(20, 12), scales=(1.0, 2.0), mode="chunk")
    assert torch.equal(yg, grouped_lora_matmul_ref(x, w, a2, b2, (20, 12), (1.0, 2.0)))
    assert [getattr(fn, attr) for fn, attr in counters] == before


def test_build_stamps_follow_the_shared_headers(tmp_path):
    """csrc/hopper.cuh is included by flash_attention.cu and, through
    bf16_wgmma_tile.cuh, by lora_matmul.cu and grouped_lora.cu: an edit to
    it rebuilds those three and no other library; an edit to the tile
    header rebuilds the two LoRA libraries."""
    import shutil
    for src in build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    names = ("lora_matmul", "grouped_lora", "quant", "wkv6", "flash_attention")
    for header, rebuilt in (("hopper.cuh", {"lora_matmul", "grouped_lora", "flash_attention"}),
                            ("bf16_wgmma_tile.cuh", {"lora_matmul", "grouped_lora"})):
        before = {n: build._digest(tmp_path / f"{n}.cu") for n in names}
        path = tmp_path / header
        path.write_text(path.read_text() + "\n// edited\n")
        after = {n: build._digest(tmp_path / f"{n}.cu") for n in names}
        assert {n for n in names if after[n] != before[n]} == rebuilt


# ----------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _row_err(got, want):
    """Worst row's relative error in the 2-norm, each row over its own scale."""
    got, want = got.float(), want.float()
    diff = torch.linalg.vector_norm(got - want, dim=-1)
    return float((diff / torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)).max())


def _cuda_inputs(m, k, n, r, dev, seed=0, groups=None):
    rs = np.random.default_rng(seed)
    lead = () if groups is None else (groups,)
    shapes = (((m, k), 1.0), ((k, n), k ** -0.5), (lead + (r, k), r ** -0.5),
              (lead + (n, r), 0.1), ((m, n), 1.0))
    return [torch.from_numpy((rs.standard_normal(s) * f).astype(np.float32)).to(BF16).to(dev)
            for s, f in shapes]


# ragged M and N against the tiles of every width, K off the 64-deep
# stage: 2100 rows x 2048 columns cover the card with 256-wide tiles
# (17 x 8 = 136), 2048 x 1000 with 128-wide ones (16 x 8), the others take
# 64-wide ones
WGMMA_SHAPES = [(2100, 512, 2048), (2048, 256, 1000), (300, 200, 264), (1000, 2048, 256),
                (129, 64, 72)]


@pytest.mark.parametrize("shape", WGMMA_SHAPES)
@pytest.mark.parametrize("r", [16, 32, 64])
def test_cuda_wgmma_tile_matches_plain_version(cuda_device, shape, r):
    """Both major-nesses of W (the forward's W, and the K-contiguous W^T of
    the views and the dx call), A by TMA and by the producer's loads (the
    views), forward and autograd: each row within 1e-2 of the plain
    version, every launch on the wgmma tile."""
    x, w, a, b, g = _cuda_inputs(*shape, r, cuda_device, seed=r)
    want = lora_matmul_ref(x, w, a, b, 2.0)
    views = [v.t().contiguous().t() for v in (w, a, b)]
    calls = [((x, w, a, b), want), ((x, *views), want),
             (_dx_call(g, w, a, b), lora_matmul_ref(*_dx_call(g, w, a, b), 2.0))]
    for ops, ref in calls:
        assert tma_ok(*ops)
        before = (lora_matmul.launches_bf16, lora_matmul.launches_wgmma)
        got = lora_matmul(*ops, scale=2.0)
        assert (lora_matmul.launches_bf16, lora_matmul.launches_wgmma) == (before[0] + 1,
                                                                            before[1] + 1)
        assert got.dtype == BF16 and _row_err(got, ref) <= 1e-2
    grads = []
    for fn in (fused_lora_matmul, None):
        xs, as_, bs = (v.clone().requires_grad_(True) for v in (x, a, b))
        yy = (fn(xs, w, as_, bs, scale=2.0) if fn is not None
              else lora_matmul_ref(xs, w, as_, bs, 2.0))
        grads.append(torch.autograd.grad(yy, (xs, as_, bs), g))
    for got, ref in zip(*grads):
        assert _row_err(got, ref) <= 1e-2


@pytest.mark.parametrize("sizes,k,n", [((100, 200), 512, 640), ((4096, 4096), 2048, 2048),
                                       ((37, 300, 5), 256, 256)])
@pytest.mark.parametrize("r", [16, 32, 64])
def test_cuda_grouped_wgmma_tile_matches_plain_version(cuda_device, sizes, k, n, r):
    """Grouped chunk mode on the wgmma tile: groups that end inside a
    128-row tile (100 rows, then 200; 37, 300, 5), whose tiles load the next
    group's rows and store none of them; forward, the dx call's views, and
    autograd, each row within 1e-2 of the plain version."""
    x, w, a, b, g = _cuda_inputs(sum(sizes), k, n, r, cuda_device, seed=r, groups=len(sizes))
    scales = tuple(0.5 + 0.5 * i for i in range(len(sizes)))
    for ops in ((x, w, a, b), _dx_call(g, w, a, b)):
        assert tma_ok(*ops)
        before = grouped_lora_chunk.launches_wgmma
        got = grouped_lora(*ops, group_sizes=sizes, scales=scales, mode="chunk")
        assert grouped_lora_chunk.launches_wgmma == before + 1
        assert _row_err(got, grouped_lora_matmul_ref(*ops, sizes, scales)) <= 1e-2
    grads = []
    for fn in (grouped_lora_matmul, None):
        xs, as_, bs = (v.clone().requires_grad_(True) for v in (x, a, b))
        yy = (fn(xs, w, as_, bs, group_sizes=sizes, scales=scales, mode="chunk")
              if fn is not None else grouped_lora_matmul_ref(xs, w, as_, bs, sizes, scales))
        grads.append(torch.autograd.grad(yy, (xs, as_, bs), g))
    for got, ref in zip(*grads):
        assert _row_err(got, ref) <= 1e-2


@pytest.mark.parametrize("case", list(CASES_TAKING_MMA_SYNC))
def test_cuda_mma_sync_tile_takes_the_rest(cuda_device, case):
    """Operands that tma_ok refuses launch the mma.sync tile (the wgmma
    counter stays) and agree with the plain version."""
    if case == "float32":
        pytest.skip("fp32 runs the 3xTF32 kernel, which test_torch_kernels holds")
    ops = CASES_TAKING_MMA_SYNC[case](cuda_device)
    rs = np.random.default_rng(1)
    # fill each operand in place, keeping its layout, alignment and views
    for t in ops:
        t.copy_(torch.from_numpy(rs.standard_normal(tuple(t.shape)).astype(np.float32) * 0.3))
    before = (lora_matmul.launches_bf16, lora_matmul.launches_wgmma)
    got = lora_matmul(*ops, scale=2.0)
    assert (lora_matmul.launches_bf16, lora_matmul.launches_wgmma) == (before[0] + 1,
                                                                        before[1])
    assert _row_err(got, lora_matmul_ref(*ops, 2.0)) <= 1e-2
