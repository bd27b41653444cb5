"""3x3 convolution through the hand-written Hopper kernels ``csrc/conv3x3.cu``.

Replaces the Pallas TPU kernels ``_conv3x3_kernel_elem`` and
``_conv3x3_kernel`` of ``stabletriton_tpu/kernels/conv_direct.py``: every
3x3, stride-1, SAME conv of the UNet (bf16) and of the VAE decoder (f32),
with the bias / per-batch bias / residual / SiLU epilogue in-kernel.

What bounds it on the H100: at the SDXL UNet shapes (K = 9*Cin = 2880 to
23040) the implicit GEMM has far more operations per byte than the card's
~295 FLOP/B balance point, so it is bound by tensor-core throughput and by
how well the A operand keeps the tensor cores fed; at SD1.5's 8^2 level
(128 output pixels a batch) by reading the weight once; the f32 VAE convs
by the tensor cores' tf32 rate (three tf32 products for each f32 one) and
the L2 traffic of re-reading each block's share of the split weight; the
decoder's conv_out (Cout 3) by reading x.

What the design does about it: an implicit GEMM (M = B*H*W, N = Cout,
K = 9*Cin) with no im2col matrix and no padded copy of the image borders.
Every bf16 conv (all 38 of SDXL's, 49 of SD1.5's) goes to the wgmma kernel:
the TMA + wgmma mainloop of ``csrc/wgmma.cuh`` with one 4-D TMA box per
(tap, 64-channel chunk) as the A operand, whose out-of-range pixels TMA
fills with zeros (the SAME border), and a pixel tile and K split from
``wgmma_plan.conv_plan`` (the 8^2 and 16^2 levels split K over blocks).
TMA reads rows of 16 bytes, so conv_in (Cin 4) gets x and w padded to 8
zero channels (:func:`_pad_cin`, 0.5 MB at SDXL's 128^2, inside the
kernel's time), and conv_out (Cout 4) runs an 8-column block tile on the
weight as a K-major (8, 9*Cin) matrix (:func:`n8_weight`, 23 KB, made at
every launch), storing its 4 real channels. A misaligned base is copied to
an aligned one. f32 convs with Cin
% 8 == 0 (all of the VAE decoder's but conv_in) go to the 3xTF32 wgmma
kernel, which keeps f32 accuracy on the tensor cores: the wrapper splits the
weight into a K-major (Cout_pad, 9*Cin) big part exact in tf32 and the small
rest (:func:`tf32_split`, plain torch on the weight at every launch, no
cache: ``chip_smoke.py`` times it beside each f32 conv, PERF.md has the
numbers), the kernel splits x the same way in registers and sums three
tf32 products. f32 convs with Cin <= 4 (the decoders' conv_in, Cin 4 ->
512, which writes 33.5 MB at 128^2 after 36 FMAs an output) go to the
direct kernel: each thread holds its 2 output channels' weights in
registers, a block of 256 spans 512 channels, the input's halo sits in
shared memory and a warp stores 256 contiguous bytes. The rest of f32
(the GroupNorm prologue, Cin > 4 and no multiple of 8, a misaligned base)
goes to the scalar kernel. The launch key names the kernel
(:func:`conv_variant`).

Routing is by shape, as in ``conv2d_direct`` of the JAX package: a 3x3,
stride-1, padding-1 conv goes to the kernel; the strided downsamplers, the
1x1 shortcuts and ``post_quant_conv`` go to the plain conv, which the JAX
package also runs outside any Pallas kernel. The plain version
(:func:`conv3x3_plain`) computes the kernel's function in PyTorch; the
wrapper uses it only for tensors on the CPU.

The same kernels with a GroupNorm prologue (K8) replace the JAX package's
fused-GN conv, ``_conv3x3_kernel_elem`` with ``gs_ref`` / ``gsh_ref``
reached from ``gn_conv2d_fused`` (binding ``gn_conv2d="fused"``): every
ResnetBlock2D GN+SiLU+conv pair and the UNet's norm_out+SiLU+conv_out. Bound
like the conv; the prologue saves the write and re-read of the normalized
activation that the unfused pair (GroupNorm apply, then conv) pays. Each
in-image input element is multiplied by its (batch, channel) f32 scale, the
shift added, SiLU applied and the result rounded to bf16 before the
tensor-core product (the JAX kernel casts before its MXU dots); the SAME
border stays exactly 0. At Cout > 8 the wgmma kernel (``conv_gn_wgmma_bf16``,
launch key "wgmma_gn_bf16") is warp-specialised: three warps of their own
turn each 64-channel chunk of the tile's halo into the bf16 operand in
shared memory (each image's scale and shift read from L2; the border and
channels past Cin set to 0, since TMA's zero fill is a raw zero) while two
others run the previous chunk's 9 taps as shared-memory wgmmas straight
from it, so each input element is normalised once a column tile, not once
per tap, and off the tensor cores' path; its grid is persistent, one block
an SM walking the output tiles (``wgmma_plan.gn_grid``), on a pixel tile 8
wide and widths 128, 192 or 256 from its own model. The 8-column form
(Cout <= 8, conv_out) normalises in its consumer warps and feeds register-A
wgmmas. The f32 scalar kernel applies it in its A-tile gather. The scale
and shift come from the GroupNorm stats and fold kernels
(``kernels/group_norm.py`` :func:`scale_shift`), which read x once, so K8
normalises with the very values K9's apply kernel would.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from stabletriton_tpu_torch.kernels import autotune, group_norm, wgmma_plan
from stabletriton_tpu_torch.kernels.build import (
    ACT_CODES, DTYPE_CODES, SILU_ACTS, LaunchCounter, check, current_stream, function,
    on_device)
from stabletriton_tpu_torch.ops import reference
from stabletriton_tpu_torch.ops.registry import dispatch, register

LAUNCHES = LaunchCounter()     # K6: the plain conv kernel
GN_LAUNCHES = LaunchCounter()  # K8: the conv with the GroupNorm prologue


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                  residual: torch.Tensor | None = None,
                  act: str | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: 3x3 stride-1 SAME conv on NHWC
    x with HWIO w, f32 accumulation and epilogue, output in x's dtype. On a
    GPU the f32 conv is full precision only with
    ``torch.backends.cudnn.allow_tf32`` off (cuDNN defaults to TF32)."""
    xf = x.float().permute(0, 3, 1, 2)
    out = F.conv2d(xf, w.float().permute(3, 2, 0, 1), None, padding=1)
    out = out.permute(0, 2, 3, 1)
    if b is not None:
        bb = b.float()
        out = out + (bb[:, None, None, :] if bb.ndim == 2 else bb)
    if residual is not None:
        out = out + residual.float()
    if act == "silu":
        out = F.silu(out)
    return out.to(x.dtype).contiguous()


_P, _I = ctypes.c_void_p, ctypes.c_int
# st_conv3x3(x, w, bias, bias_dtype, bias_bstride, residual, out, B, H, W,
#            Cin, Cout, act, gn_scale, gn_shift, gn_act, stream): f32 only
_CONV_ARGTYPES = [_P, _P, _P, _I, ctypes.c_longlong, _P, _P] + [_I] * 6 + [_P, _P, _I, _P]
# st_conv3x3_tf32x3(x, w_big, w_small, bias, bias_dtype, bias_bstride,
#                   residual, out, B, H, W, Cin, Cout, cout_pad, act, tw, th,
#                   tb, stream)
_TF32_ARGTYPES = [_P, _P, _P, _P, _I, ctypes.c_longlong, _P, _P] + [_I] * 10 + [_P]
# st_conv3x3_wgmma(x, w, bias, bias_dtype, bias_bstride, residual, out, ws,
#                  B, H, W, Cin, Cout, act, gn_scale, gn_shift, gn_act,
#                  tw, th, tb, bn, splits, grid, stream)
_WGMMA_ARGTYPES = ([_P, _P, _P, _I, ctypes.c_longlong, _P, _P, _P] + [_I] * 6
                   + [_P, _P, _I] + [_I] * 6 + [_P])
# st_conv3x3_direct(x, w, bias, bias_dtype, bias_bstride, residual, out, B, H,
#                   W, Cin, Cout, act, stream): f32, Cin <= DIRECT_MAX_CIN
_DIRECT_ARGTYPES = [_P, _P, _P, _I, ctypes.c_longlong, _P, _P] + [_I] * 6 + [_P]
DIRECT_MAX_CIN = 4  # the direct kernel's largest instance (csrc/conv3x3.cu)


def conv_variant(x_shape: tuple[int, ...], cout: int, dtype: torch.dtype,
                 aligned: bool = True, gn: bool = False) -> str | None:
    """The kernel that takes a 3x3 conv of x (B, H, W, Cin) to ``cout``
    channels: in bf16 where ``wgmma_plan.conv_fits`` (Cout a multiple of 8
    or at most 8; any Cin; at Cout <= 8 room for the prologue's staging)
    "wgmma_gn_bf16" with the GroupNorm prologue at Cout > 8 (K8's
    warp-specialised kernel), else "wgmma_bf16", and None where no kernel
    takes it; in float32 without a GroupNorm prologue
    "direct_f32" for Cin <= DIRECT_MAX_CIN (any alignment) and
    "wgmma_tf32x3" for Cin % 8 == 0 with x aligned (``aligned``: x's base
    is 16-byte aligned); "scalar" for the rest."""
    if dtype != torch.bfloat16:
        if gn:
            return "scalar"
        if x_shape[3] <= DIRECT_MAX_CIN:
            return "direct_f32"
        return "wgmma_tf32x3" if x_shape[3] % 8 == 0 and aligned else "scalar"
    if not wgmma_plan.conv_fits(*x_shape, cout, gn=gn):
        return None
    return "wgmma_gn_bf16" if gn and cout > wgmma_plan.N8 else "wgmma_bf16"


def n8_weight(w: torch.Tensor) -> torch.Tensor:
    """The HWIO weight (3, 3, Cin, Cout <= 8) as the 8-column kernel's B
    operand: K-major (8, 9*Cin), row n holding w[ky, kx, ci, n] at k = (3 ky
    + kx) Cin + ci, rows past Cout zero."""
    cin, cout = w.shape[2], w.shape[3]
    return F.pad(w.reshape(9 * cin, cout).t(), (0, 0, 0, wgmma_plan.N8 - cout)).contiguous()


def _pad_cin(x, w, gn):
    """x, w and the prologue's scale / shift with Cin padded to a multiple
    of 8 by zero channels (TMA reads rows of 16 bytes): a zero channel
    normalises to SiLU(0 * 0 + 0) = 0 and meets zero weights."""
    pad = -x.shape[3] % 8
    if not pad:
        return x, w, gn
    if gn is not None:
        gn = (F.pad(gn[0], (0, pad)), F.pad(gn[1], (0, pad)), gn[2])
    return F.pad(x, (0, pad)), F.pad(w, (0, 0, 0, pad)), gn


def _aligned(t):
    """t, or a copy whose base is 16-byte aligned (TMA's and the 16-byte
    vector stores' terms)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 HWIO weight (3, 3, Cin, Cout) as the tf32 kernel's K-major B
    operand: two (Cout_pad, 9*Cin) f32 matrices, Cout padded to a multiple
    of 8 with zero rows, big = w with its low 13 mantissa bits cleared
    (exact in tf32) and small = w - big (exact in f32), so big + small == w."""
    cin, cout = w.shape[2], w.shape[3]
    wt = w.float().reshape(9 * cin, cout).t()
    return wgmma_plan.tf32_parts(F.pad(wt, (0, 0, 0, -cout % 8)))


def _check_conv(x, w, b, residual, act):
    n, h, wd, cin = x.shape
    if w.shape[:3] != (3, 3, cin):
        raise ValueError(f"weight {tuple(w.shape)} is not (3, 3, {cin}, Cout)")
    cout = w.shape[3]
    if act not in SILU_ACTS:
        raise ValueError(f"conv kernel epilogue takes act in {list(SILU_ACTS)}, got {act!r}")
    if b is not None and b.shape not in ((cout,), (n, cout)):
        raise ValueError(f"bias {tuple(b.shape)} is neither ({cout},) nor ({n}, {cout})")
    if residual is not None and residual.shape != (n, h, wd, cout):
        raise ValueError(f"residual {tuple(residual.shape)} is not {(n, h, wd, cout)}")


def tuned_plan(n, h, wd, cin, cout, gn, has_res, act) -> wgmma_plan.Plan | None:
    """The autotune table's plan for the wgmma conv at one shape (its
    ``conv3x3`` key, ``:gn`` with the GroupNorm prologue), checked against
    what the kernel takes, or None where the table names no plan. An entry
    the kernel cannot take raises, naming its key."""
    key = autotune.conv_key(n, h, wd, cin, cout, torch.bfloat16, has_res, act, gn)
    entry = autotune.plan_entry(key)
    if entry is None:
        return None
    autotune.check_entry(key, entry, ("bn", "splits"))
    plan = wgmma_plan.Plan(entry["bn"], entry["splits"])
    widths = ((wgmma_plan.N8,) if cout <= wgmma_plan.N8 else
              wgmma_plan.GN_WIDTHS if gn else wgmma_plan.WIDTHS)
    steps = 1 if cout <= wgmma_plan.N8 else 9 * -(-cin // wgmma_plan.BK)
    if plan.bn not in widths or not 1 <= plan.splits <= min(steps, wgmma_plan.MAX_SPLITS):
        raise ValueError(f"autotune entry {key} = {entry}: the wgmma conv takes bn in {widths} "
                         f"and 1 <= splits <= {min(steps, wgmma_plan.MAX_SPLITS)} here")
    return plan


@functools.lru_cache(maxsize=None)
def _wgmma_route(n, h, wd, cin, cout, gn, has_res=False, act=None, plan=None):
    """The wgmma conv's pixel tile, plan (``plan``, else the autotune
    table's, else ``wgmma_plan.conv_plan``'s) and launch key at one shape
    (Cin as the caller gave it; the plan's at Cin padded to 8; cached: the
    host time of a launch is the step's budget; :func:`autotune.record`
    clears the cache). K8 at Cout > 8 keys its persistent grid too
    (:func:`_gn_grid`)."""
    cin8 = -(-cin // 8) * 8
    tile, rule = wgmma_plan.conv_plan(n, h, wd, cin8, cout, gn=gn)
    plan = plan or tuned_plan(n, h, wd, cin, cout, gn, has_res, act) or rule
    shape = (f"b={n} {h}x{wd} {cin}->{cout} tile={tile.tw}x{tile.th}x{tile.tb} bn={plan.bn} "
             f"split={plan.splits}")
    if gn and cout > wgmma_plan.N8:
        return tile, plan, f"wgmma_gn_bf16 {shape} grid={_gn_grid(n, h, wd, cout, tile, plan)}"
    return tile, plan, f"wgmma_bf16 {shape}"


@functools.lru_cache(maxsize=None)
def _gn_grid(n, h, wd, cout, tile, plan) -> int:
    """K8's persistent grid at Cout > 8 (``wgmma_plan.gn_grid``); 0, which
    the other wgmma convs ignore, at Cout <= 8 (cached as the route is)."""
    if cout <= wgmma_plan.N8:
        return 0
    return wgmma_plan.gn_grid(math.prod(tile.counts(n, h, wd)), cout, plan)


def _launch(x, w, b, residual, act, gn=None, variant=None, plan=None
            ) -> tuple[torch.Tensor, str]:
    """Launch a conv kernel on CUDA operands; ``gn`` is (scale, shift, gn_act)
    for the GroupNorm prologue; ``variant`` names the kernel, else
    :func:`conv_variant` picks it; ``plan`` (the tuner's candidate) replaces
    the wgmma kernel's route's. Returns the output and the launch key."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    dtype = x.dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"conv kernel takes float32 or bfloat16, got {dtype}")
    dev = x.device
    if w.dtype != dtype or (residual is not None and residual.dtype != dtype):
        raise ValueError("conv kernel takes x, w and residual of one dtype")
    if b is not None and b.dtype not in DTYPE_CODES:
        raise ValueError(f"conv kernel takes a float32 or bfloat16 bias, got {b.dtype}")
    tensors = [x, w] + [t for t in (b, residual) if t is not None]
    if gn is not None:
        tensors += list(gn[:2])
        if any(t.dtype != torch.float32 for t in gn[:2]):
            raise ValueError("GroupNorm scale and shift must be float32")
    if any(t.device != dev for t in tensors):
        raise ValueError("conv operands lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv kernel takes contiguous operands")
    if variant is None:
        variant = conv_variant(tuple(x.shape), cout, dtype, x.data_ptr() % 16 == 0,
                               gn is not None)
    if variant is None:
        raise ValueError(f"no conv kernel takes {tuple(x.shape)} -> {cout} in {dtype}"
                         + (" with the GroupNorm prologue" if gn is not None else ""))
    wgmma = variant in ("wgmma_bf16", "wgmma_gn_bf16") and dtype == torch.bfloat16
    if wgmma:
        tile, plan, key = _wgmma_route(n, h, wd, cin, cout, gn is not None,
                                       residual is not None, act, plan)
        grid = _gn_grid(n, h, wd, cout, tile, plan) if gn is not None else 0
        x, w, gn = _pad_cin(_aligned(x), w, gn)
        if gn is not None:
            gn, b = (_aligned(gn[0]), _aligned(gn[1]), gn[2]), _aligned(b)
        w = n8_weight(w) if plan.bn == wgmma_plan.N8 else _aligned(w)
        residual = _aligned(residual)
    out = torch.empty((n, h, wd, cout), dtype=dtype, device=dev)
    bias_args = ((None, 0, 0) if b is None else
                 (b.data_ptr(), DTYPE_CODES[b.dtype], cout if b.dim() == 2 else 0))
    res_ptr = None if residual is None else residual.data_ptr()
    gn_args = ((None, None, 0) if gn is None else
               (gn[0].data_ptr(), gn[1].data_ptr(), ACT_CODES[gn[2]]))
    with on_device(dev):
        stream = current_stream(dev)
        if wgmma:
            ws = (torch.empty((plan.splits, n * h * wd, cout), dtype=torch.float32, device=dev)
                  if plan.splits > 1 else None)
            code = function("st_conv3x3_wgmma", _WGMMA_ARGTYPES)(
                x.data_ptr(), w.data_ptr(), *bias_args, res_ptr, out.data_ptr(),
                None if ws is None else ws.data_ptr(), n, h, wd, x.shape[3], cout,
                ACT_CODES[act], *gn_args, tile.tw, tile.th, tile.tb, plan.bn, plan.splits, grid,
                stream)
            check(code, "st_conv3x3_wgmma")
            return out, key
        if variant == "wgmma_tf32x3":
            if dtype != torch.float32 or gn is not None or cin % 8 or x.data_ptr() % 16:
                raise ValueError("the tf32 conv kernel takes float32 x with Cin % 8 == 0 and a "
                                 "16-byte aligned base, and no GroupNorm prologue")
            big, small = tf32_split(w)
            tile = wgmma_plan.conv_tile(n, h, wd)
            code = function("st_conv3x3_tf32x3", _TF32_ARGTYPES)(
                x.data_ptr(), big.data_ptr(), small.data_ptr(), *bias_args, res_ptr,
                out.data_ptr(), n, h, wd, cin, cout, big.shape[0], ACT_CODES[act], tile.tw,
                tile.th, tile.tb, stream)
            check(code, "st_conv3x3_tf32x3")
            return out, (f"wgmma_tf32x3 b={n} {h}x{wd} {cin}->{cout} "
                         f"tile={tile.tw}x{tile.th}x{tile.tb}")
        if variant == "direct_f32":
            if dtype != torch.float32 or gn is not None or cin > DIRECT_MAX_CIN:
                raise ValueError(f"the direct conv kernel takes float32 x with Cin <= "
                                 f"{DIRECT_MAX_CIN} and no GroupNorm prologue")
            code = function("st_conv3x3_direct", _DIRECT_ARGTYPES)(
                x.data_ptr(), w.data_ptr(), *bias_args, res_ptr, out.data_ptr(), n, h, wd, cin,
                cout, ACT_CODES[act], stream)
            check(code, "st_conv3x3_direct")
            return out, f"direct_f32 b={n} {h}x{wd} {cin}->{cout}"
        if variant != "scalar" or dtype != torch.float32:
            raise ValueError(f"conv kernel {variant!r} does not take {dtype} operands")
        code = function("st_conv3x3", _CONV_ARGTYPES)(
            x.data_ptr(), w.data_ptr(), *bias_args, res_ptr, out.data_ptr(),
            n, h, wd, cin, cout, ACT_CODES[act], *gn_args, stream)
    check(code, "st_conv3x3")
    return out, f"{variant} b={n} {h}x{wd} {cin}->{cout}"


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
            residual: torch.Tensor | None = None,
            act: str | None = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv: x (B, H, W, Cin), w (3, 3, Cin, Cout), b (Cout,)
    or (B, Cout), residual (B, H, W, Cout). CPU tensors take the plain version."""
    _check_conv(x, w, b, residual, act)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, residual=residual, act=act)
    out, key = _launch(x, w, b, residual, act)
    LAUNCHES.add(key)
    return out


def gn_conv3x3_plain(x: torch.Tensor, gn_scale: torch.Tensor, gn_shift: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor | None = None, *,
                     residual: torch.Tensor | None = None, act: str | None = None,
                     gn_act: str | None = "silu") -> torch.Tensor:
    """The fused kernel's function in plain PyTorch: x * scale + shift (+SiLU)
    in f32 per (batch, channel), rounded to x's dtype, then
    :func:`conv3x3_plain`, whose zero padding lies outside the normalized
    input."""
    xn = group_norm.apply_plain(x, gn_scale, gn_shift, gn_act)
    return conv3x3_plain(xn, w, b, residual=residual, act=act)


def gn_conv3x3(x: torch.Tensor, gn_scale: torch.Tensor, gn_shift: torch.Tensor,
               w: torch.Tensor, b: torch.Tensor | None = None, *,
               residual: torch.Tensor | None = None, act: str | None = None,
               gn_act: str | None = "silu") -> torch.Tensor:
    """The 3x3 conv with the GroupNorm apply fused into its input read:
    ``gn_scale`` / ``gn_shift`` (B, Cin) f32 from :func:`group_norm.scale_shift`.
    CPU tensors take the plain version."""
    _check_conv(x, w, b, residual, act)
    if gn_act not in SILU_ACTS:
        raise ValueError(f"conv kernel prologue takes gn_act in {list(SILU_ACTS)}, "
                         f"got {gn_act!r}")
    if gn_scale.shape != (x.shape[0], x.shape[3]) or gn_shift.shape != gn_scale.shape:
        raise ValueError(f"GroupNorm scale {tuple(gn_scale.shape)} / shift "
                         f"{tuple(gn_shift.shape)} are not {(x.shape[0], x.shape[3])}")
    if x.device.type == "cpu":
        return gn_conv3x3_plain(x, gn_scale, gn_shift, w, b, residual=residual, act=act,
                                gn_act=gn_act)
    out, key = _launch(x, w, b, residual, act, (gn_scale, gn_shift, gn_act))
    GN_LAUNCHES.add(f"{key} gn_act={gn_act}")
    return out


def _is_conv3x3_s1(w, stride, padding) -> bool:
    """A 3x3 stride-1 SAME conv on an unquantized weight: a turbo (int8,
    scale) pair steps aside, as in the JAX package."""
    return (not isinstance(w, tuple) and w.dim() == 4 and tuple(w.shape[:2]) == (3, 3)
            and stride == 1 and padding == 1)


@register("conv2d", "direct")
def conv2d_direct(x, w, b=None, *, stride=1, padding=1, residual=None, act=None):
    """3x3 stride-1 SAME convs go to the kernel; other shapes (strided, 1x1,
    asymmetric padding) and quantized weights go to the plain conv, as in
    the JAX package."""
    if _is_conv3x3_s1(w, stride, padding) and act in SILU_ACTS:
        return conv3x3(x, w.to(x.dtype), b, residual=residual, act=act)
    return reference.conv2d(x, w, b, stride=stride, padding=padding,
                            residual=residual, act=act)


@register("gn_conv2d", "fused")
def gn_conv2d_fused(x, gamma, beta, w, b=None, *, num_groups=32, eps=1e-5,
                    gn_act="silu", stride=1, padding=1, residual=None, act=None):
    """GroupNorm(+gn_act) -> 3x3 conv with the GN apply fused into the conv's
    input read: the GroupNorm stats and fold kernels (one C entry) read x
    once and write (B, C) scale / shift, and the conv kernel normalizes its
    input as it gathers it.
    Ineligible shapes (not 3x3 stride 1 SAME, C not divisible by the groups,
    an activation or a shape no kernel takes) and quantized weights compose
    ``group_norm`` -> ``conv2d`` through the active binding, as in the JAX
    package (under int8_conv that conv is the int8 op)."""
    if (_is_conv3x3_s1(w, stride, padding) and act in SILU_ACTS and gn_act in SILU_ACTS
            and x.shape[3] % num_groups == 0
            and conv_variant(tuple(x.shape), w.shape[3], x.dtype, gn=True) is not None):
        scale, shift = group_norm.scale_shift(x, gamma, beta, num_groups=num_groups, eps=eps)
        return gn_conv3x3(x, scale, shift, w.to(x.dtype), b, residual=residual, act=act,
                          gn_act=gn_act)
    h = dispatch("group_norm", x, gamma, beta, num_groups=num_groups, eps=eps, act=gn_act)
    return dispatch("conv2d", h, w, b, stride=stride, padding=padding,
                    residual=residual, act=act)
