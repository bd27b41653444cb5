"""Tile width, pixel tile and K split of the Hopper wgmma kernels
(``csrc/wgmma.cuh``: ``linear_wgmma_bf16``, ``conv_wgmma_bf16``; K8,
``conv_gn_wgmma_bf16`` in ``csrc/conv3x3.cu``), and the split of f32
operands into tf32 parts that the 3xTF32 kernels take.

The fitted rule below is a pure function of the shape, but it comes second:
each wrapper's route first looks the shape up in the autotune table
(``kernels/autotune.py``: the plans measured on the card, packaged for a
card in ``kernels/tuned/<platform>.json`` and cached per user) and takes
this module's plan only for a shape the table lacks. Either way the same
shape gets the same plan on one card, so a launch repeats bit for bit, and
the CPU tests cover every choice. Plans are cached by shape: the eager step
launches ~550 GEMMs and convs, and the search costs tens of microseconds of
host time.

A block computes a 128-row output tile of width ``bn`` (128 or 256; 8 for a
3x3 conv to Cout <= 8, which runs unsplit) over a
share of the K steps (64 wide); one block runs on each of the card's 132
SMs at a time (two at width 128, to overlap one block's epilogue with the
other's mainloop). Where the output tiles alone leave SMs idle (SDXL's
(2048, ., 1280) GEMMs and 32^2 convs: 160 tiles, 1.2 waves; the cross K/V
precompute: 40 tiles; SD1.5's 8^2 conv: 10 tiles) the planner splits K
over blocks, which write f32 partials that a second kernel sums in split
order. It picks the plan of least modelled time:

    a launch
    + waves x (a block's fill and epilogue + its K steps x one step's time),
      or the bytes the call must move over the memory rate, if longer
    + with a split, the reduction's launch and the partials' write and read.

A step's time is its operations at the H100's bf16 peak (989 TFLOP/s over
132 SMs) over the share of it the mainloop sustains. The shares and the
fixed costs were fitted to the wgmma kernels' times at forced plans on an
H100 80GB HBM3 at 700 W (``kernel_table.py --plans`` prints them beside the
planner's choice); they rank plans and are no measurement of any one call.

K8 at Cout > 8 (the GroupNorm prologue) has a model of its own: its pixel
tile is 8 pixels wide (8 x 16, or 8 x 8 x 2 images where the image is 8
rows or fewer), its widths 128, 192 and 256, and its grid persistent, one
block an SM walking the (split, row tile, column tile) items, so a "wave"
is the items an SM walks, and each item pays its epilogue
(``GN_TILE_SECONDS``) and the kernel once the first halo's load and
normalisation (``GN_FILL_SECONDS``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

SMS = 132                  # H100 SXM streaming multiprocessors
BM, BK = 128, 64           # the block tile's rows and K step (csrc/wgmma.cuh)
WIDTHS = (128, 256)        # the block tile's widths
N8 = 8                     # the 3x3 conv's width for Cout <= 8
MAX_SPLITS = 16
PEAK_FLOPS = 989e12        # bf16 dense tensor-core rate
MEMORY_BYTES_PER_S = 3.35e12
# fitted (see above): the mainloop's share of the peak, and a block's fill
# and epilogue (at width 128 two blocks share an SM and half hide it)
SUSTAINED = {128: 0.73, 256: 0.93}
BLOCK_SECONDS = {128: 2.3e-6, 256: 7.5e-6}
LAUNCH_SECONDS, REDUCE_SECONDS = 4e-6, 3e-6
SMEM_BYTES = 232448        # dynamic shared memory a block may take
# dynamic shared memory K8's 8-column form (Cout <= 8) may give the (scale,
# shift) staging of its tile's images beside its rings (csrc/conv3x3.cu
# conv_gn_wgmma_bf16_n8: 4 B stages of 1 KB, 2 halo stages of at most 25
# KB, 12 barriers)
GN_STAGING_BYTES = SMEM_BYTES - (1024 + 4 * BK * N8 * 2 + 2 * 25600 + 16 * 6)
# K8 at Cout > 8 (csrc/conv3x3.cu conv_gn_wgmma_bf16): its widths, its
# block tile's rows and pixel tile's width, its halo ring's depth and the
# most stages of its weight ring, and the fitted share of the peak its
# mainloop sustains, an item's epilogue and the kernel's first halo
GN_WIDTHS = (128, 192, 256)
GN_BM, GN_TW = 128, 8
GN_HSTAGES, GN_MAX_BSTAGES = 4, 8
GN_SUSTAINED = {128: 0.40, 192: 0.45, 256: 0.52}
GN_TILE_SECONDS = {128: 1.5e-6, 192: 2.0e-6, 256: 2.5e-6}
GN_FILL_SECONDS = 3e-6


@dataclass(frozen=True)
class Plan:
    bn: int      # block tile width
    splits: int  # blocks sharing one output tile's K steps


@dataclass(frozen=True)
class ConvTile:
    tw: int  # pixels across
    th: int  # rows
    tb: int  # images: tw * th * tb == BM

    def counts(self, b: int, h: int, w: int) -> tuple[int, int, int]:
        """Tiles across W, H and the batch."""
        return math.ceil(w / self.tw), math.ceil(h / self.th), math.ceil(b / self.tb)


def split_ranges(steps: int, splits: int) -> list[tuple[int, int]]:
    """The K steps [start, stop) of each split, as the kernels take them."""
    return [(z * steps // splits, (z + 1) * steps // splits) for z in range(splits)]


def modelled_seconds(m_tiles: int, n: int, steps: int, out_rows: int, bytes_moved: int,
                     bn: int, splits: int) -> float:
    """The model's time of one plan (module docstring)."""
    n_tiles = math.ceil(n / bn)
    step_seconds = BM * bn * BK * 2 / (PEAK_FLOPS * SUSTAINED[bn] / SMS)
    waves = math.ceil(m_tiles * n_tiles * splits / SMS)
    seconds = LAUNCH_SECONDS + max(
        waves * (BLOCK_SECONDS[bn] + math.ceil(steps / splits) * step_seconds),
        bytes_moved / MEMORY_BYTES_PER_S)
    if splits > 1:
        seconds += REDUCE_SECONDS + 2 * splits * out_rows * n * 4 / MEMORY_BYTES_PER_S
    return seconds


def gn_modelled_seconds(m_tiles: int, n: int, steps: int, out_rows: int, bytes_moved: int,
                        bn: int, splits: int) -> float:
    """The model's time of one plan of K8 at Cout > 8 (module docstring)."""
    items = m_tiles * math.ceil(n / bn) * splits
    step_seconds = GN_BM * bn * BK * 2 / (PEAK_FLOPS * GN_SUSTAINED[bn] / SMS)
    seconds = LAUNCH_SECONDS + GN_FILL_SECONDS + max(
        math.ceil(items / SMS) * (GN_TILE_SECONDS[bn] + math.ceil(steps / splits) * step_seconds),
        bytes_moved / MEMORY_BYTES_PER_S)
    if splits > 1:
        seconds += REDUCE_SECONDS + 2 * splits * out_rows * n * 4 / MEMORY_BYTES_PER_S
    return seconds


def plan(m_tiles: int, n: int, steps: int, out_rows: int, bytes_moved: int,
         widths: tuple[int, ...] = WIDTHS, model=modelled_seconds) -> Plan:
    """The plan of least modelled time for ``m_tiles`` row tiles, ``n``
    output columns and ``steps`` K steps; ``out_rows`` x ``n`` outputs."""
    best = min((model(m_tiles, n, steps, out_rows, bytes_moved, bn, splits), splits, bn)
               for bn in widths for splits in range(1, min(steps, MAX_SPLITS) + 1))
    return Plan(bn=best[2], splits=best[1])


@functools.lru_cache(maxsize=None)
def gemm_plan(m: int, k: int, n: int) -> Plan:
    """The plan of an (m, k) @ (k, n) bf16 GEMM."""
    return plan(math.ceil(m / BM), n, math.ceil(k / BK), m, (m * k + k * n + m * n) * 2)


@functools.lru_cache(maxsize=None)
def conv_tile(b: int, h: int, w: int) -> ConvTile:
    """The 128-pixel tile of a (b, h, w) image batch: 16 x 8 pixels where
    the image is wider than 8, else 8 x 8 pixels of two images (SD1.5's 8^2
    level: one tile for the batch)."""
    tw = 16 if w > 8 else 8
    return ConvTile(tw, 8, BM // (tw * 8))


@functools.lru_cache(maxsize=None)
def gn_conv_tile(b: int, h: int, w: int) -> ConvTile:
    """K8's pixel tile at Cout > 8, 128 pixels: 8 wide (an output row's 8
    pixels are one core matrix of its A operand) and 16 rows, or 8 rows of
    two images where the image has 8 rows or fewer (SD1.5's 8^2 level)."""
    th = 16 if h > 8 else 8
    return ConvTile(GN_TW, th, GN_BM // (GN_TW * th))


def _gn_smem(bn: int, tile: ConvTile, bstages: int) -> int:
    plane = -(-(GN_TW + 2) * (tile.th + 2) * tile.tb * 16 // 128) * 128
    return 1024 + bstages * BK * bn * 2 + GN_HSTAGES * 8 * plane + 8 * (2 * bstages
                                                                        + 3 * GN_HSTAGES)


def gn_bstages(bn: int, tile: ConvTile) -> int:
    """The stages of K8's weight ring: as many as fit beside its halo ring
    (csrc/conv3x3.cu gn_bstages), at most GN_MAX_BSTAGES."""
    return max(s for s in range(2, GN_MAX_BSTAGES + 1)
               if s == 2 or _gn_smem(bn, tile, s) <= SMEM_BYTES)


def gn_smem_bytes(bn: int, tile: ConvTile) -> int:
    """K8's dynamic shared memory at Cout > 8 (csrc/conv3x3.cu
    gn_smem_bytes): the weight ring, the halo ring (8 planes of 8 channels a
    stage, 16 bytes a pixel, each padded to 128 bytes) and its barriers."""
    return _gn_smem(bn, tile, gn_bstages(bn, tile))


def gn_grid(m_tiles: int, n: int, plan: Plan) -> int:
    """K8's persistent grid: a block an SM, or one an item where there are
    fewer items."""
    return min(m_tiles * math.ceil(n / plan.bn) * plan.splits, SMS)


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, h: int, w: int, cin: int, cout: int, *,
              gn: bool = False) -> tuple[ConvTile, Plan]:
    """The pixel tile and plan of a 3x3 conv; a conv to Cout <= 8 (the
    UNet's conv_out) runs at width 8 unsplit; K8 otherwise on its own tile,
    widths and model."""
    tile = gn_conv_tile(b, h, w) if gn and cout > N8 else conv_tile(b, h, w)
    if cout <= N8:
        return tile, Plan(bn=N8, splits=1)
    m_tiles = math.prod(tile.counts(b, h, w))
    steps = 9 * math.ceil(cin / BK)
    moved = (b * h * w * (cin + cout) + 9 * cin * cout) * 2
    if gn:
        return tile, plan(m_tiles, cout, steps, b * h * w, moved, GN_WIDTHS, gn_modelled_seconds)
    return tile, plan(m_tiles, cout, steps, b * h * w, moved)


def tf32_parts(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 t as contiguous big + small, the B operand of the 3xTF32 kernels:
    big = t with its low 13 mantissa bits cleared (exact in tf32), small =
    t - big (exact in f32), so big + small == t."""
    t = t.float().contiguous()
    big = (t.view(torch.int32) & -8192).view(torch.float32)  # -8192 = 0xFFFFE000
    return big, t - big


def gemm_fits(m: int, k: int, n: int, aligned: bool) -> bool:
    """Whether the wgmma GEMM takes the shape: TMA needs 16-byte aligned
    bases and 16-byte row strides (k % 8 == n % 8 == 0 in bf16). The grid
    walks the output tiles along blockIdx.x, so no row count is too many."""
    return aligned and k > 0 and k % 8 == 0 and n % 8 == 0


@functools.lru_cache(maxsize=None)
def conv_fits(b: int, h: int, w: int, cin: int, cout: int, *, gn: bool = False) -> bool:
    """Whether the wgmma conv takes the shape: Cout a multiple of 8 (TMA's
    16-byte rows, as for the GEMM) or at most 8 (the 8-column tile); any
    Cin, which the wrapper pads to a multiple of 8; with the prologue at
    Cout <= 8, the images' scale and shift must fit beside the rings (at
    Cout > 8 K8 reads them from L2)."""
    cin8 = -(-cin // 8) * 8
    return ((cout % 8 == 0 or cout <= N8)
            and (not gn or cout > N8 or conv_tile(b, h, w).tb * cin8 * 8 <= GN_STAGING_BYTES))
