"""The wgmma kernels' host side on the CPU: routing, the tile / split
planner, and the split-K summation order against the plain versions and the
JAX package's Pallas kernels.

A CUDA kernel has no interpret mode, so what the CPU can hold is what
surrounds the kernels: which shapes and alignments reach ``wgmma_bf16``
(``kernels/linear.py`` :func:`variant`, ``kernels/conv_direct.py``
:func:`conv_variant`); that the plans of ``kernels/wgmma_plan.py`` cover
every output once and every K step once, repeat themselves, and split the
grids that leave SMs idle; and that summing f32 partials over the planned K
ranges in split order (what ``splitk_reduce`` does) computes the function of
the unsplit plain versions and of JAX's ``fused_linear`` and
``conv3x3_direct`` (interpret mode). Tolerance 1e-4 of the largest output,
float32: only the summation order differs. The 3x3 conv's 8-column tile
(Cout <= 8) and its padded operands (Cin to 8, the K-major weight) against
the plain and Pallas convs. For the wgmma attention kernel: which classes
reach it, and its box layout's arithmetic against ``attention_plain``. The
kernels themselves run on the card in tests/test_torch_port_gpu.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.kernels.conv_direct import conv3x3_direct
from stabletriton_tpu.kernels.linear import fused_linear
from stabletriton_tpu_torch.kernels import conv_direct as tconv
from stabletriton_tpu_torch.kernels import flash_attention as tfa
from stabletriton_tpu_torch.kernels import linear as tlinear
from stabletriton_tpu_torch.kernels import wgmma_plan as wp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16

# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,aligned,want", [
    (8192, 640, 1920, True, "wgmma_bf16"),    # SDXL to_qkv
    (154, 2048, 2560, True, "wgmma_bf16"),    # the cross K/V precompute
    (17, 8, 8, True, "wgmma_bf16"),           # the smallest TMA shape above the skinny rows
    (130, 37, 45, True, "wmma_bf16"),         # K, N not multiples of 8
    (70, 64, 4, True, "wmma_bf16"),           # N = 4
    (150, 128, 64, False, "wmma_bf16"),       # a base off 16 bytes
    (300, 0, 64, True, "wmma_bf16"),          # K = 0: no TMA box
    (16, 1280, 1280, True, "skinny_bf16"),
    (2, 1280, 1280, False, "skinny_bf16"),
])
def test_linear_routes_bf16_by_tma_terms(m, k, n, aligned, want):
    assert tlinear.variant(m, k, n, BF16, aligned) == want


def test_linear_routes_f32_by_rows():
    assert tlinear.variant(16384, 512, 512, torch.float32) == "wgmma_tf32x3"
    assert tlinear.variant(16, 512, 512, torch.float32) == "skinny_f32"


def test_linear_routes_past_the_grid_limit_to_wmma():
    """The wgmma grid walks its output tiles along blockIdx.x, so rows past
    CUDA's 65535-block limit on grid.y stay on wgmma; only what TMA cannot
    take (here a misaligned base) goes to the WMMA kernel, at any row count."""
    rows = (65535 + 1) * wp.BM
    assert tlinear.variant(rows, 64, 64, BF16) == "wgmma_bf16"
    assert tlinear.variant(rows - wp.BM, 64, 64, BF16) == "wgmma_bf16"
    assert tlinear.variant(rows, 64, 64, BF16, aligned=False) == "wmma_bf16"
    assert tconv.conv_variant((2, 2048, 2048, 64), 64, BF16) == "wgmma_bf16"


# every bf16 3x3 conv shape of the SDXL 1024^2 UNet (CFG batch 2): all 38
# go to wgmma, conv_in with Cin padded to 8, conv_out at the 8-column tile
SDXL_CONVS = [((2, 128, 128, 4), 320, "wgmma_bf16"), ((2, 128, 128, 320), 4, "wgmma_bf16"),
              ((2, 128, 128, 320), 320, "wgmma_bf16"), ((2, 64, 64, 320), 640, "wgmma_bf16"),
              ((2, 64, 64, 640), 640, "wgmma_bf16"), ((2, 32, 32, 640), 1280, "wgmma_bf16"),
              ((2, 32, 32, 1280), 1280, "wgmma_bf16"), ((2, 32, 32, 2560), 1280, "wgmma_bf16"),
              ((2, 64, 64, 1920), 640, "wgmma_bf16"), ((2, 128, 128, 960), 320, "wgmma_bf16"),
              ((2, 8, 8, 1280), 1280, "wgmma_bf16"), ((2, 16, 16, 2560), 1280, "wgmma_bf16")]


@pytest.mark.parametrize("shape,cout,want", SDXL_CONVS)
def test_conv_routes_by_tma_terms(shape, cout, want):
    assert tconv.conv_variant(shape, cout, BF16) == want
    # the GroupNorm prologue: K8's warp-specialised kernel at Cout > 8, its
    # 8-column form on the wgmma conv's tile at Cout <= 8
    assert tconv.conv_variant(shape, cout, BF16, gn=True) == (
        "wgmma_gn_bf16" if cout > wp.N8 else want)
    # a misaligned bf16 base is copied to an aligned one: the same kernel
    assert tconv.conv_variant(shape, cout, BF16, aligned=False) == "wgmma_bf16"
    # f32: Cin 4 on the direct kernel at any alignment, Cin % 8 == 0 on the
    # 3xTF32 one where x is aligned, else the scalar one
    f32 = "wgmma_tf32x3" if shape[3] % 8 == 0 else "direct_f32"
    assert tconv.conv_variant(shape, cout, torch.float32) == f32
    assert tconv.conv_variant(shape, cout, torch.float32, aligned=False) == (
        "scalar" if shape[3] % 8 == 0 else "direct_f32")


def test_conv_prologue_routes_by_staging_room():
    """The 8-column form of the GroupNorm prologue (Cout <= 8) stages
    (scale, shift) of the tile's images beside its rings: Cin past what
    fits has no kernel (the wrapper raises, gn_conv2d "fused" composes
    GroupNorm and conv); K8 at Cout > 8 reads them from L2 and takes any
    Cin; a bf16 Cout neither a multiple of 8 nor at most 8 has no kernel."""
    fits = wp.GN_STAGING_BYTES // 8  # channels at one image a tile
    assert tconv.conv_variant((2, 32, 32, fits // 8 * 8), 4, BF16, gn=True) == "wgmma_bf16"
    assert tconv.conv_variant((2, 32, 32, fits // 8 * 8 + 8), 4, BF16, gn=True) is None
    assert tconv.conv_variant((2, 32, 32, fits // 8 * 8 + 8), 4, BF16) == "wgmma_bf16"
    assert tconv.conv_variant((2, 32, 32, fits // 8 * 8 + 8), 64, BF16,
                              gn=True) == "wgmma_gn_bf16"
    # 8 x 8 images: two to a tile, half the channels
    assert tconv.conv_variant((2, 8, 8, fits // 8 * 8), 4, BF16, gn=True) is None
    assert tconv.conv_variant((2, 8, 8, fits // 8 * 8), 64, BF16, gn=True) == "wgmma_gn_bf16"
    assert tconv.conv_variant((2, 8, 8, 64), 12, BF16) is None
    assert tconv.conv_variant((2, 8, 8, 64), 12, BF16, gn=True) is None
    assert tconv.conv_variant((2, 8, 8, 64), 12, torch.float32) == "wgmma_tf32x3"


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------

# (m, k, n) of every bf16 GEMM with M > 16 on the SDXL and SD1.5 paths
GEMMS = [(8192, 640, 1920), (8192, 640, 640), (8192, 640, 5120), (8192, 2560, 640),
         (2048, 1280, 3840), (2048, 1280, 1280), (2048, 1280, 10240), (2048, 5120, 1280),
         (154, 2048, 2560), (154, 2048, 1280), (8192, 320, 960), (8192, 320, 320),
         (8192, 1280, 320), (2048, 640, 640), (512, 1280, 1280), (128, 1280, 1280),
         (154, 768, 640), (300, 136, 200), (17, 8, 8)]


@pytest.mark.parametrize("m,k,n", GEMMS)
def test_gemm_plan_covers_outputs_and_k_once(m, k, n):
    plan = wp.gemm_plan(m, k, n)
    assert plan == wp.gemm_plan(m, k, n)  # a pure function of the shape
    assert plan.bn in wp.WIDTHS and 1 <= plan.splits <= wp.MAX_SPLITS
    steps = math.ceil(k / wp.BK)
    ranges = wp.split_ranges(steps, plan.splits)
    covered = [s for a, b in ranges for s in range(a, b)]
    assert covered == list(range(steps)) and all(b > a for a, b in ranges)
    # the grid's blocks (blockIdx.x -> row tile, column tile as in
    # wg::block_tile) cover every output tile once
    m_tiles, n_tiles = math.ceil(m / wp.BM), math.ceil(n / plan.bn)
    tiles = [divmod(bx, n_tiles) for bx in range(m_tiles * n_tiles)]
    assert sorted(tiles) == [(i, j) for i in range(m_tiles) for j in range(n_tiles)]
    rows = [r for t in range(m_tiles) for r in range(t * wp.BM, (t + 1) * wp.BM) if r < m]
    cols = [c for t in range(n_tiles) for c in range(t * plan.bn, (t + 1) * plan.bn) if c < n]
    assert rows == list(range(m)) and cols == list(range(n))


def test_small_grids_get_a_split():
    """Grids under one wave split K: SDXL's 32^2 convs (160 tiles of 128),
    the 40-tile precompute and SD1.5's 8^2 and 16^2 convs (10 and 40 tiles).
    SDXL's 160-tile ff out takes 80 tiles of width 256 instead (80 K steps
    each: a split's partials would cost more than the idle SMs); the full
    grids neither split nor widen."""
    assert wp.conv_tile(2, 32, 32).counts(2, 32, 32) == (2, 4, 2)  # 16 row tiles
    assert wp.conv_plan(2, 32, 32, 1280, 1280)[1].splits > 1
    assert wp.gemm_plan(154, 2048, 2560).splits > 1
    assert wp.conv_plan(2, 8, 8, 1280, 1280)[1].splits > 1
    assert wp.conv_plan(2, 16, 16, 1280, 1280)[1].splits > 1
    assert wp.gemm_plan(2048, 5120, 1280) == wp.Plan(256, 1)
    assert wp.gemm_plan(8192, 640, 1920) == wp.Plan(128, 1)
    assert wp.conv_plan(2, 128, 128, 320, 320)[1] == wp.Plan(128, 1)


def test_prologue_plans_run_at_width_128():
    """K8 at Cout > 8 plans on its own widths (128, 192, 256) and its own
    tile: 8 pixels wide, 16 rows, or 8 rows of two images at 8 x 8."""
    for b, h, w, cin, cout in [(2, 32, 32, 2560, 1280), (2, 8, 8, 1280, 1280),
                               (2, 16, 16, 640, 640)]:
        tile, plan = wp.conv_plan(b, h, w, cin, cout, gn=True)
        assert plan.bn in wp.GN_WIDTHS
        assert tile == (wp.ConvTile(8, 8, 2) if h == 8 else wp.ConvTile(8, 16, 1))
    # SD1.5's 8^2 level: 10 row tiles of two images fill no wave, so K splits
    assert wp.conv_plan(2, 8, 8, 2560, 1280, gn=True)[1].splits > 1


# (b, h, w, cin, cout) of every K8 shape at Cout > 8 of SDXL-base 1024^2 at
# UNet batch 2 and 16 (the resnets' GroupNorm + SiLU + conv pairs), the
# refiner's 128^2 384 -> 384, SD1.5's 8^2 2560 -> 1280 (split) and ragged
# images
GN_SHAPES = [(b, h, h, cin, cout) for b in (2, 16) for h, cin, cout in [
    (128, 320, 320), (128, 640, 320), (128, 960, 320), (64, 320, 640), (64, 640, 640),
    (64, 960, 640), (64, 1280, 640), (64, 1920, 640), (32, 640, 1280), (32, 1280, 1280),
    (32, 1920, 1280), (32, 2560, 1280)]] + [
    (2, 128, 128, 384, 384), (2, 8, 8, 2560, 1280), (1, 8, 8, 1280, 1280), (2, 13, 17, 72, 200),
    (3, 5, 6, 64, 24), (2, 12, 12, 1280, 1280)]


def _gn_items(m_tiles, n_tiles, splits, block, grid):
    """The (split, row tile, column tile) items block ``block`` of K8's
    persistent grid walks, in order, as the kernel decodes them (csrc/
    conv3x3.cu gn_item): items block, block + grid, ...; column tile
    fastest, split slowest."""
    tiles = m_tiles * n_tiles
    return [(i // tiles, i % tiles // n_tiles, i % n_tiles)
            for i in range(block, tiles * splits, grid)]


@pytest.mark.parametrize("b,h,w,cin,cout", GN_SHAPES)
def test_gn_plan_fits_and_walks_every_item_once(b, h, w, cin, cout):
    """K8's plan at Cout > 8: the same shape always gets the same plan; its
    dynamic shared memory fits the 232,448 bytes a block may take; the
    persistent grid's blocks, walking items blockIdx.x, + grid, ... as the
    kernel decodes them, reach every (split, row tile, column tile) exactly
    once; the splits cover the K steps once; and the pixel tile reaches
    every output pixel once, with each warpgroup's 64 rows inside one
    image (8 output rows of 8 pixels: the A operand's 8 core matrices).
    The weight ring takes at least 4 stages beside the halo ring."""
    tile, plan = wp.conv_plan(b, h, w, cin, cout, gn=True)
    assert (tile, plan) == wp.conv_plan(b, h, w, cin, cout, gn=True)
    wp.conv_plan.cache_clear()
    assert (tile, plan) == wp.conv_plan(b, h, w, cin, cout, gn=True)
    assert plan.bn in wp.GN_WIDTHS and 1 <= plan.splits <= wp.MAX_SPLITS
    assert wp.gn_smem_bytes(plan.bn, tile) <= wp.SMEM_BYTES
    assert wp.gn_bstages(plan.bn, tile) >= 3
    assert tile.tw == wp.GN_TW and tile.tw * tile.th * tile.tb == wp.GN_BM
    assert (tile.th * tile.tw) % 64 == 0
    m_tiles, n_tiles = math.prod(tile.counts(b, h, w)), math.ceil(cout / plan.bn)
    grid = wp.gn_grid(m_tiles, cout, plan)
    assert 1 <= grid <= wp.SMS
    walked = [it for blk in range(grid)
              for it in _gn_items(m_tiles, n_tiles, plan.splits, blk, grid)]
    assert sorted(walked) == [(z, mt, nt) for z in range(plan.splits) for mt in range(m_tiles)
                              for nt in range(n_tiles)]
    steps = 9 * math.ceil(cin / wp.BK)
    covered = [s for a, e in wp.split_ranges(steps, plan.splits) for s in range(a, e)]
    assert covered == list(range(steps))
    ntx, nty, _ = tile.counts(b, h, w)
    seen = np.zeros((b, h, w), np.int64)
    for mt in range(m_tiles):
        x0, y0, b0 = (mt % ntx) * tile.tw, (mt // ntx % nty) * tile.th, mt // (ntx * nty) * tile.tb
        for row in range(wp.GN_BM):
            bb = b0 + row // (tile.th * tile.tw)
            y, x = y0 + row % (tile.th * tile.tw) // tile.tw, x0 + row % tile.tw
            if bb < b and y < h and x < w:
                seen[bb, y, x] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,h,w", [(2, 128, 128), (2, 64, 64), (2, 32, 32), (2, 16, 16),
                                   (2, 8, 8), (1, 8, 8), (2, 13, 17), (3, 5, 6), (1, 9, 40),
                                   (2, 40, 7)])
def test_conv_tiles_cover_every_pixel_once(b, h, w):
    """The kernel's walk over pixel tiles (row tile -> x0, y0, b0, as in
    conv_wgmma_bf16) reaches every output pixel exactly once."""
    tile = wp.conv_tile(b, h, w)
    assert tile.tw * tile.th * tile.tb == wp.BM
    ntx, nty, ntb = tile.counts(b, h, w)
    seen = np.zeros((b, h, w), np.int64)
    for mt in range(ntx * nty * ntb):
        x0, y0 = (mt % ntx) * tile.tw, (mt // ntx % nty) * tile.th
        b0 = mt // (ntx * nty) * tile.tb
        for row in range(wp.BM):
            bb = b0 + row // (tile.th * tile.tw)
            y, x = y0 + row % (tile.th * tile.tw) // tile.tw, x0 + row % tile.tw
            if bb < b and y < h and x < w:
                seen[bb, y, x] += 1
    assert (seen == 1).all()


# (b, h, w, cin, cout) of convs to Cout <= 8: SDXL's and SD1.5's conv_out,
# ragged tiles, Cout 8 itself
N8_CONVS = [(2, 128, 128, 320, 4), (2, 64, 64, 320, 4), (1, 128, 128, 320, 4),
            (2, 13, 17, 72, 3), (1, 8, 8, 8, 8), (3, 5, 6, 64, 1)]


@pytest.mark.parametrize("b,h,w,cin,cout", N8_CONVS)
def test_conv_plan_at_width_8_covers_outputs_once(b, h, w, cin, cout):
    """Cout <= 8 runs the 8-column tile, unsplit, with or without the
    prologue: one column tile, every K step in its one block, and the
    grid's blocks (blockIdx.x -> pixel tile) reach every output once; the
    epilogue stores columns 2 (lane % 4) + c < Cout of each row."""
    for gn in (False, True):
        tile, plan = wp.conv_plan(b, h, w, cin, cout, gn=gn)
        assert plan == wp.Plan(wp.N8, 1) and (tile, plan) == wp.conv_plan(b, h, w, cin, cout, gn=gn)
    assert tconv.conv_variant((b, h, w, cin), cout, BF16) == "wgmma_bf16"
    steps = 9 * math.ceil(cin / wp.BK)
    assert wp.split_ranges(steps, 1) == [(0, steps)]
    ntx, nty, ntb = tile.counts(b, h, w)
    n_tiles = math.ceil(cout / wp.N8)
    assert n_tiles == 1
    seen = np.zeros((b, h, w, cout), np.int64)
    for bx in range(ntx * nty * ntb * n_tiles):
        mt, nt = divmod(bx, n_tiles)
        x0, y0, b0 = (mt % ntx) * tile.tw, (mt // ntx % nty) * tile.th, mt // (ntx * nty) * tile.tb
        for row in range(wp.BM):
            bb = b0 + row // (tile.th * tile.tw)
            y, x = y0 + row % (tile.th * tile.tw) // tile.tw, x0 + row % tile.tw
            if bb < b and y < h and x < w:
                for lane in range(4):
                    for c in range(2):
                        n = nt * wp.N8 + 2 * lane + c
                        if n < cout:
                            seen[bb, y, x, n] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("cin,cout", [(4, 320), (320, 4), (4, 4), (3, 5)])
def test_padded_conv_operands_compute_the_conv(cin, cout):
    """What the wrapper hands the wgmma kernel for conv_in and conv_out: x
    and w with Cin padded to 8 by zero channels, and for Cout <= 8 the
    K-major (8, 9*Cin) weight with zero rows past Cout. The implicit GEMM
    over them (K step kb: tap kb, the padded channels) is the conv of the
    plain version and of JAX's Pallas kernel (interpret mode), f32, 1e-5."""
    rng = np.random.default_rng(cin * cout)
    x = rng.standard_normal((2, 6, 7, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / math.sqrt(9 * cin)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, bias))
    xp, wpad, _ = tconv._pad_cin(xt, wt, None)
    cin8 = xp.shape[3]
    assert cin8 == -(-cin // 8) * 8 and torch.equal(xp[..., :cin], xt) and not xp[..., cin:].any()
    if cout <= wp.N8:
        b_op = tconv.n8_weight(wpad)                        # (8, 9 * cin8), K-major
        assert b_op.shape == (wp.N8, 9 * cin8) and b_op.is_contiguous()
        assert not b_op[cout:].any()
        b_op = b_op.t()
    else:
        b_op = wpad.reshape(9 * cin8, cout)
    xpad = torch.nn.functional.pad(xp, (0, 0, 1, 1, 1, 1)).double()
    acc = torch.zeros((2, 6, 7, b_op.shape[1]), dtype=torch.float64)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        acc += xpad[:, ky:ky + 6, kx:kx + 7] @ b_op[tap * cin8:(tap + 1) * cin8].double()
    got = (acc[..., :cout].float() + bt).numpy()
    plain = tconv.conv3x3_plain(xt, wt, bt).numpy()
    pallas = np.asarray(conv3x3_direct(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                       interpret=True))
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-5 * scale
    assert np.abs(got - pallas).max() <= 1e-5 * scale


@pytest.mark.parametrize("cin,cout", [(320, 320), (1280, 1280), (2560, 1280), (64, 96), (40, 8)])
def test_conv_plan_covers_k_once(cin, cout):
    tile, plan = wp.conv_plan(2, 16, 16, cin, cout)
    assert (tile, plan) == wp.conv_plan(2, 16, 16, cin, cout)
    steps = 9 * math.ceil(cin / wp.BK)
    covered = [s for a, b in wp.split_ranges(steps, plan.splits) for s in range(a, b)]
    assert covered == list(range(steps))


# --------------------------------------------------------------------------
# split-K summation order
# --------------------------------------------------------------------------


def _gemm_split_sum(x, w, b, act, splits):
    """f32 partials over each split's K steps (64 wide), summed in split
    order, then the epilogue: the function of linear_wgmma_bf16 +
    splitk_reduce in plain PyTorch."""
    k = x.shape[1]
    total = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    for a, e in wp.split_ranges(math.ceil(k / wp.BK), splits):
        part = torch.zeros_like(total)
        for s in range(a, e):
            ks = slice(s * wp.BK, min(k, (s + 1) * wp.BK))
            part += x[:, ks].float() @ w[ks].float()
        total += part
    if b is not None:
        total += b.float()
    if act == "silu":
        total = torch.nn.functional.silu(total)
    elif act == "gelu":
        total = torch.nn.functional.gelu(total)
    return total


def _conv_split_sum(x, w, bias, residual, act, splits):
    """The same for the implicit-GEMM conv: K step kb is tap kb // chunks,
    channels (kb % chunks) * 64 ... + 64 of the zero-padded input."""
    bsz, h, wd, cin = x.shape
    chunks = math.ceil(cin / wp.BK)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    total = torch.zeros((bsz, h, wd, w.shape[3]), dtype=torch.float32)
    for a, e in wp.split_ranges(9 * chunks, splits):
        part = torch.zeros_like(total)
        for kb in range(a, e):
            tap, c = divmod(kb, chunks)
            ky, kx = divmod(tap, 3)
            cs = slice(c * wp.BK, min(cin, (c + 1) * wp.BK))
            part += xp[:, ky:ky + h, kx:kx + wd, cs] @ w[ky, kx, cs].float()
        total += part
    total += bias.float()[:, None, None, :] if bias.dim() == 2 else bias.float()
    if residual is not None:
        total += residual.float()
    return torch.nn.functional.silu(total) if act == "silu" else total


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
@pytest.mark.parametrize("act", [None, "gelu"])
def test_gemm_split_sum_matches_plain_and_pallas(splits, act):
    rng = np.random.default_rng(50 + splits)
    m, k, n = 40, 300, 24   # K = 4 steps of 64 and a ragged fifth
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    got = _gemm_split_sum(xt, wt, bt, act, splits)
    assert _rel(got, tlinear.linear_plain(xt, wt, bt, act=act)) <= 1e-4
    pallas = fused_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act, interpret=True)
    assert _rel(got, pallas) <= 1e-4


@pytest.mark.parametrize("splits", [1, 2, 4, 9])
@pytest.mark.parametrize("batch_bias", [False, True])
def test_conv_split_sum_matches_plain_and_pallas(splits, batch_bias):
    rng = np.random.default_rng(60 + splits)
    bsz, h, wd, cin, cout = 2, 6, 7, 72, 16   # two channel chunks a tap, 18 K steps
    x = rng.standard_normal((bsz, h, wd, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / math.sqrt(9 * cin)).astype(np.float32)
    bias = rng.standard_normal((bsz, cout) if batch_bias else (cout,)).astype(np.float32)
    res = rng.standard_normal((bsz, h, wd, cout)).astype(np.float32)
    xt, wt, bt, rt = (torch.from_numpy(a) for a in (x, w, bias, res))
    got = _conv_split_sum(xt, wt, bt, rt, "silu", splits)
    assert _rel(got, tconv.conv3x3_plain(xt, wt, bt, residual=rt, act="silu")) <= 1e-4
    pallas = conv3x3_direct(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                            residual=jnp.asarray(res), act="silu", interpret=True)
    assert _rel(got, pallas) <= 1e-4


def test_bias_dtype_reaches_the_plain_versions_unchanged():
    """The wrappers no longer cast a bf16 bias to f32 per call; on the CPU
    the plain versions add it in f32 (bf16 -> f32 is exact), so a bf16 bias
    and its f32 copy give the same bits."""
    rng = np.random.default_rng(70)
    x = torch.from_numpy(rng.standard_normal((20, 32)).astype(np.float32)).to(BF16)
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32)).to(BF16)
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32)).to(BF16)
    assert torch.equal(tlinear.linear(x, w, b), tlinear.linear(x, w, b.float()))
    xc = torch.from_numpy(rng.standard_normal((1, 5, 5, 8)).astype(np.float32)).to(BF16)
    wc = torch.from_numpy(rng.standard_normal((3, 3, 8, 8)).astype(np.float32) / 8).to(BF16)
    assert torch.equal(tconv.conv3x3(xc, wc, b[:8]), tconv.conv3x3(xc, wc, b[:8].float()))


# --------------------------------------------------------------------------
# the wgmma attention kernel (attn_wgmma_bf16<D>): routing and tiles
# --------------------------------------------------------------------------

# (h, d, sk) of the SDXL and SD1.5 paths' attention launches -> the kernel
ATTENTION_KERNELS = {(20, 64, 1024): "wgmma_bf16", (10, 64, 77): "tinykv_wgmma_bf16",
                     (20, 64, 77): "tinykv_wgmma_bf16", (10, 64, 4096): "wgmma_bf16",
                     (8, 40, 4096): "wgmma_bf16", (8, 80, 1024): "wgmma_bf16",
                     (8, 160, 256): "wgmma_bf16", (8, 40, 77): "tinykv_wgmma_bf16",
                     (8, 160, 64): "tinykv_wgmma_bf16"}


@pytest.mark.parametrize("h,d,sk", sorted(ATTENTION_KERNELS))
def test_attention_classes_route_to_kernels(h, d, sk):
    """bf16 at most 128 keys (K5, K1's cross-attention) runs the tiny-KV
    wgmma kernel, above it the wgmma kernel; f32 the 3xTF32 GEMM."""
    cls = tfa.attention_class(h, d, sk)
    assert tfa.kernel_name(BF16, sk) == ATTENTION_KERNELS[(h, d, sk)]
    assert (sk <= 128) == (ATTENTION_KERNELS[(h, d, sk)] == "tinykv_wgmma_bf16")
    assert cls != "K5" or sk <= 128
    assert tfa.kernel_name(torch.float32, sk) == "wgmma_tf32x3"


def _box_attention(qkv, h, d, sk_pad):
    """attn_wgmma_bf16's arithmetic on a fused (B, S, 3C) buffer, in plain
    PyTorch: each operand read as ceil(D / 64) boxes of 64 columns from the
    head's first column (the next head's columns, TMA's zeros past the
    operand's last), Q prescaled and rounded with its columns from D on
    zeroed, S over ceil(D / 16) k16 steps, keys padded with zero rows to
    tiles of 64 and masked by index, P rounded to bf16, O over every box
    column, the first D kept."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    boxes, k_steps = -(-d // 64), -(-d // 16)
    width = 64 * boxes
    qscale = torch.tensor(tfa.LOG2E / math.sqrt(d), dtype=BF16)
    outs = []
    for head in range(h):
        def box(off, rows):
            cols = qkv[:, :, off + head * d: off + c].float()   # the map ends at off + C
            cols = torch.nn.functional.pad(cols, (0, max(0, width - cols.shape[2])))[..., :width]
            return torch.nn.functional.pad(cols, (0, 0, 0, rows - s))
        q = (box(0, s).to(BF16) * qscale).float()
        q[..., d:] = 0
        k, v = box(c, sk_pad), box(2 * c, sk_pad)
        sc = q[..., : 16 * k_steps] @ k[..., : 16 * k_steps].transpose(1, 2)
        p = torch.exp2(torch.clamp(sc, max=tfa.SOFTMAX_CLIP))
        p[..., s:] = 0
        o = p.to(BF16).float() @ v
        outs.append((o / p.sum(-1, keepdim=True).clamp(min=1e-30))[..., :d])
    return torch.cat(outs, -1).to(BF16)


@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_wgmma_attention_boxes_compute_attention(d):
    """The head-dim padding of the box layout adds exactly 0 to the scores
    and nothing to the stored columns: with the next head's columns in every
    box, the box arithmetic equals attention_plain (bf16 outputs, f32 sums:
    at most 0.1% of the outputs one rounding apart)."""
    h, s = 3, 77
    rng = np.random.default_rng(d)
    qkv = torch.from_numpy(rng.standard_normal((2, s, 3 * h * d)).astype(np.float32)).to(BF16)
    got = _box_attention(qkv, h, d, sk_pad=128)
    want = tfa.attention_plain(*qkv.chunk(3, -1), num_heads=h)
    assert got.shape == want.shape
    assert (got != want).float().mean().item() <= 1e-3
    assert _rel(got.float(), want.float()) <= 1e-2
