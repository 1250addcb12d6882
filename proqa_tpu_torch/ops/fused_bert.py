"""The BERT layer's fused epilogues: F1, the dense epilogue, and F2, the
residual add with LayerNorm, with their backward kernels; and the forms of
both that the pre-norm decoder (models/mistral.py) runs.

On the TPU, XLA fuses the work around each product of a BERT layer into the
product's output, in the forward and in the backward; there is no Pallas
kernel for it. In eager PyTorch each of these ops is a pass over f32
activations. Hand-written kernels take their place:

- F1, `dense_epilogue` (csrc/dense_epilogue.cu): the f32 product plus the
  f32 bias, rounded once to the output dtype (proqa_tpu/models/bert.py:147-150);
  with `gelu`, exact GELU in f32 on that rounded value, rounded again
  (:273-274). Bound by bytes: 6 B an element in bf16. Its backward gives the
  pre-activation's gradient dz (with GELU: ATen's exact-GELU backward on the
  saved pre-activation, rounded once) and the bias gradient, a column sum.
- F2, `add_layer_norm` (csrc/layer_norm.cu): x + residual rounded to the
  activation dtype, then LayerNorm in f32 with a two-pass variance, scale and
  bias in f32, and one rounding (:137-144 with the residuals at :277, :286;
  the embedding LayerNorm at :241 has none). Bound by bytes: 6 B an element
  with a residual, 4 B without. Its backward gives the one gradient of x and
  the residual and the scale and bias gradients, column sums.

The decoder's forms, forward only (the decoder runs no autograd route):

- F1's SwiGLU form, `swiglu` (csrc/dense_epilogue.cu): the gate and up
  products side by side, [..., 2 I] in the activation dtype, to
  round(silu(gate) * up) in f32, [..., I]; ATen's silu expression.
- F2's RMSNorm form, `add_rms_norm` (csrc/layer_norm.cu): s = round(x +
  residual), then round((s * rsqrt(mean(s^2) + eps)) * scale) in f32 with a
  scale in the activation dtype; it returns both, s being the next residual.
  Rows up to LN_ROW_WIDTH (8,192) wide, a block a row; the card refuses
  wider ones.

Two routes, which the model picks (models/bert.py): where no autograd graph
is recorded, `dense_epilogue` and `add_layer_norm` run the forward kernels
and save nothing; where one is, `dense` (the product, bias and GELU of a
dense layer in one autograd Function) and `add_layer_norm_grad` run the same
kernels, keep what their backward kernels read, and run those in backward.
The column sums are deterministic (per-block partials, then sums in a fixed
order, in the same launch; the scratch for them is one zeroed buffer a
stream, `_workspace`), so a rematerialised forward and backward give the
same bits.

Every width runs on the card. Each kernel has forms for the widths it
meets (`dense_form`, `layer_norm_form`: from the width, the dtype and the
pointers' alignment alone): F1 stages the bias row in shared memory up to
12,288 columns and reads it through the read-only cache past that; F2 gives
a warp a row up to 1,024, a block a row in registers up to 8,192 (its
backward 4,096), and a block a streamed row past that; F1's backward sums
in ticketed slabs up to 131,072 columns and in one slab past that. The
wrapper passes the form's index, and the entry point refuses a form it
would not pick itself.

CUDA tensors run the kernels and raise where a kernel cannot take them;
`dense_epilogue` and `add_layer_norm` raise where a gradient is asked for.
CPU tensors run the plain PyTorch versions: the chains the model ran before
the kernels existed, and explicit formulas of their gradients. No wrapper
drops to a plain version on the card; only `_eager_chain()`, a yardstick for
the checks on the card (chip_smoke.py, tests/test_torch_cuda.py), makes the
training route run the plain chain there, under autograd.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from proqa_tpu_torch import _build
from proqa_tpu_torch.ops.dot import dot_f32, dot_f32_backward, product_f32

_DTYPES = (torch.bfloat16, torch.float32)

# where each kernel's forms change. The choosers run on the CPU too, where no
# kernel library is built, so they keep these here; each entry point refuses
# a form that its own copy (kMaxCols and kMaxSlabCols in csrc/dense_epilogue.cu;
# kMaxWidth, kRowWidth and kBwdRowWidth in csrc/layer_norm.cu) would not pick
DENSE_STAGED_COLS = 12_288  # F1: the bias row in 48 KB of shared memory up to here
DENSE_SLAB_COLS = 131_072   # F1 backward: ticketed slabs up to here (4 KB of counters)
LN_WARP_WIDTH = 1_024       # F2: a warp a row up to here, 32 floats a lane
LN_ROW_WIDTH = 8_192        # F2: a block a row in registers up to here, then streamed
LN_BWD_ROW_WIDTH = 4_096    # F2 backward: the same, 16 floats a thread
# the forms, in the order of the entry points' form indices
DENSE_FORMS = ("staged", "staged_scalar", "wide", "wide_scalar", "swiglu", "swiglu_scalar")
DENSE_BWD_FORMS = ("slabs", "slabs_scalar", "direct")
LN_FORMS = ("warp", "warp_scalar", "row", "row_scalar", "stream", "stream_scalar",
            "rms_row", "rms_row_scalar")
LN_BWD_FORMS = ("tile", "tile_scalar", "row", "row_scalar", "stream", "stream_scalar")

# kernel launches since the last clear() (the main path's proof of use), by
# kernel and form: "F1 staged", "F1 swiglu", "F2 rms_row", "F2 backward row"
# and so on; the forward kernels count on both routes. launches() sums a
# kernel's forms.
form_launches: dict[str, int] = {}


def launches(kernel: str) -> int:
    """The launches of `kernel` ("F1", "F2", "F1 backward" or "F2
    backward") in form_launches, over its forms."""
    return sum(n for key, n in form_launches.items() if key.rsplit(" ", 1)[0] == kernel)


_EAGER = False  # _eager_chain(): the training route runs the plain chain


@contextlib.contextmanager
def _eager_chain():
    """Inside, `dense` and `add_layer_norm_grad` run the plain PyTorch chain
    under autograd on any device: the yardstick the kernels' training route
    is held to on the card. No entry point enters it."""
    global _EAGER
    before, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = before


# --- plain versions ---

def _dense_epilogue_plain(y, bias, out_dtype, gelu):
    z = (y + bias).to(out_dtype)
    out = torch.nn.functional.gelu(z.float(), approximate="none").to(out_dtype) if gelu else z
    return out, z


def dense_epilogue_reference(y: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype,
                             gelu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of F1."""
    return _dense_epilogue_plain(y, bias, out_dtype, gelu)[0]


def dense_epilogue_backward_reference(dout: torch.Tensor, z: torch.Tensor | None, gelu: bool,
                                      need_dbias: bool = True):
    """Plain PyTorch version of F1's backward: (dz, dbias). With gelu,
    dz = round(aten::gelu_backward(f32(dout), f32(z))) in dout's dtype, the
    gradient the plain chain's autograd gives; without, dz is dout. dbias is
    the f32 column sum of dz, None unless needed."""
    dz = dout
    if gelu:
        dz = torch.ops.aten.gelu_backward(dout.float(), z.float(),
                                          approximate="none").to(dout.dtype)
    dbias = dz.float().reshape(-1, dz.shape[-1]).sum(0) if need_dbias else None
    return dz, dbias


def _layer_norm_plain(x, residual, scale, bias, eps):
    if residual is not None:
        x = x + residual
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean) * rstd
    return (y * scale + bias).to(x.dtype), mean.squeeze(-1), rstd.squeeze(-1)


def swiglu_reference(y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of F1's SwiGLU form: y [..., 2 I] holds the gate
    product in its first I columns and the up product in the rest;
    round(silu(gate) * up) in f32, [..., I] in y's dtype."""
    gate, up = y.float().chunk(2, dim=-1)
    return (torch.nn.functional.silu(gate) * up).to(y.dtype)


def add_rms_norm_reference(x: torch.Tensor, residual: torch.Tensor | None,
                           scale: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of F2's RMSNorm form: (out, s) with s = x +
    residual rounded to x's dtype (x itself without a residual) and out =
    round((s * rsqrt(mean(s^2) + eps)) * scale) in f32."""
    s = x if residual is None else x + residual
    s32 = s.float()
    rstd = torch.rsqrt(s32.square().mean(dim=-1, keepdim=True) + eps)
    return ((s32 * rstd) * scale.float()).to(x.dtype), s


def add_layer_norm_reference(x: torch.Tensor, residual: torch.Tensor | None,
                             scale: torch.Tensor, bias: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """Plain PyTorch version of F2."""
    return _layer_norm_plain(x, residual, scale, bias, eps)[0]


def add_layer_norm_backward_reference(dy, x, residual, mean, rstd, scale,
                                      need_params: bool = True):
    """Plain PyTorch version of F2's backward: (dx, dscale, dbias), the
    gradient of LayerNorm(round(x + residual)) as one formula over the
    forward's f32 mean and rstd (shape x.shape[:-1]): with
    x^ = (s - mean) * rstd and g = f32(dy) * scale,
    dx = round(rstd * (g - mean(g) - x^ * mean(g x^))) in x's dtype (the
    gradient of x and of the residual alike), dscale = the column sum of
    dy x^, dbias = that of dy (None unless need_params)."""
    s = x if residual is None else x + residual
    xh = (s.float() - mean[..., None]) * rstd[..., None]
    dy32 = dy.float()
    g = dy32 * scale
    dx = rstd[..., None] * (g - g.mean(dim=-1, keepdim=True)
                            - xh * (g * xh).mean(dim=-1, keepdim=True))
    dscale = dbias = None
    if need_params:
        h = x.shape[-1]
        dscale = (dy32 * xh).reshape(-1, h).sum(0)
        dbias = dy32.reshape(-1, h).sum(0)
    return dx.to(x.dtype), dscale, dbias


# --- the kernels ---

def _no_gradient(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it where no autograd graph is "
                           f"recorded (a recorded graph takes fused_bert.dense or "
                           f"add_layer_norm_grad)")


def _check_params(name: str, width: int, device, *params) -> None:
    for p in params:
        if p.dtype != torch.float32 or p.shape != (width,) or p.device != device:
            raise ValueError(f"{name}: parameters must be f32 [{width}] on {device}, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")


def _check_like(name: str, what: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype != like.dtype or t.shape != like.shape or t.device != like.device:
        raise ValueError(f"{name}: {what} {t.dtype} {tuple(t.shape)} on {t.device} does not "
                         f"match {like.dtype} {tuple(like.shape)} on {like.device}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _aligned(*tensors) -> bool:
    """Every tensor (None skipped) starts on a 16-byte boundary."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def dense_form(cols: int, aligned: bool, backward: bool = False, swiglu: bool = False) -> str:
    """The form F1 (or its backward, or its SwiGLU form) takes for rows of
    `cols` output columns whose pointers are all 16-byte aligned or not (the
    product, the output and z; the backward's dout, z and dz): a name of
    DENSE_FORMS (DENSE_BWD_FORMS). The vector bodies want whole groups of 8
    columns and aligned pointers."""
    if cols < 1:
        raise ValueError(f"dense_epilogue: {cols} columns")
    scalar = "" if aligned and cols % 8 == 0 else "_scalar"
    if swiglu:
        return "swiglu" + scalar
    if backward:
        return "direct" if cols > DENSE_SLAB_COLS else "slabs" + scalar
    return ("staged" if cols <= DENSE_STAGED_COLS else "wide") + scalar


def layer_norm_form(h: int, dtype: torch.dtype, aligned: bool, backward: bool = False,
                    rms: bool = False) -> str:
    """The form F2 (or its backward, or its RMSNorm form) takes for rows of
    width h in `dtype` whose pointers are all 16-byte aligned or not (x, the
    residual, the output and the parameters; the backward's dy, x, the
    residual, dx and the scale; the RMSNorm form's x, the residual, the
    scale, the output and the sum): a name of LN_FORMS (LN_BWD_FORMS). The
    vector bodies want h a multiple of the 16-byte vector (8 bf16, 4 f32)
    and aligned pointers. The RMSNorm form takes a block a row, up to
    LN_ROW_WIDTH: no configuration has a wider decoder, so it refuses more."""
    if h < 1:
        raise ValueError(f"add_layer_norm: width {h}")
    if rms:
        if h > LN_ROW_WIDTH:
            raise ValueError(f"add_rms_norm: width {h} past the RMSNorm form's {LN_ROW_WIDTH}")
        layout = "rms_row"
    elif h <= LN_WARP_WIDTH:
        layout = "tile" if backward else "warp"
    elif h <= (LN_BWD_ROW_WIDTH if backward else LN_ROW_WIDTH):
        layout = "row"
    else:
        layout = "stream"
    return layout if aligned and h % (16 // dtype.itemsize) == 0 else layout + "_scalar"


def _count(kernel: str, form: str) -> None:
    key = f"{kernel} {form.removesuffix('_scalar')}"
    form_launches[key] = form_launches.get(key, 0) + 1


# (device index, stream) -> the backward kernels' scratch on that stream
_WORKSPACES: dict[tuple[int, int], torch.Tensor] = {}


@functools.lru_cache(maxsize=256)
def _scratch_bytes(entry: str, *args) -> int:
    """The C side's size query `entry` (_build.query), once for each shape
    and device: the answer follows from them and the card alone."""
    return _build.query(entry, *args)


def _workspace(device: torch.device, nbytes: int) -> torch.Tensor:
    """The backward kernels' scratch for their column sums on `device`'s
    current stream, at least nbytes: per-block partials and ticket counters
    that must be zero the first time and that every launch leaves at zero.
    So one zeroed buffer a stream serves every call, F1's and F2's in turn
    (launches on one stream run in order); it grows where a call needs more."""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < nbytes:
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=device)
        _WORKSPACES[key] = ws
    return ws


def _dense_epilogue_kernel(y, bias, out_dtype, gelu, save_z=False):
    """F1; with save_z (gelu only) also the rounded pre-activation z."""
    if y.dtype != torch.float32 or out_dtype not in _DTYPES:
        raise TypeError(f"dense_epilogue kernel takes an f32 product to bf16 or f32, got "
                        f"{y.dtype} to {out_dtype}")
    cols = y.shape[-1]
    _check_params("dense_epilogue", cols, y.device, bias)
    y, bias = y.contiguous(), bias.contiguous()
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    z = torch.empty_like(out) if save_z and gelu else None
    form = dense_form(cols, _aligned(y, out, z))
    if out.numel():
        _build.launch("proqa_dense_epilogue", y.device, y.data_ptr(), bias.data_ptr(),
                      out.data_ptr(), _ptr(z), y.numel() // cols, cols,
                      int(out_dtype == torch.bfloat16), int(gelu), DENSE_FORMS.index(form))
        _count("F1", form)
    return out, z


def _dense_epilogue_backward_kernel(dout, z, gelu, need_dz, need_dbias):
    """F1's backward on the card: (dz, dbias) as dense_epilogue_backward_reference."""
    if dout.dtype not in _DTYPES:
        raise TypeError(f"dense_epilogue backward takes bf16 or f32, got {dout.dtype}")
    cols = dout.shape[-1]
    dout = dout.contiguous()
    if gelu:
        _check_like("dense_epilogue backward", "z", z, dout)
    dz = torch.empty_like(dout) if gelu and need_dz else (dout if need_dz else None)
    if not (gelu and need_dz) and not need_dbias:
        return dz, None
    rows = dout.numel() // cols
    device = dout.device
    z = z.contiguous() if gelu else None
    form = dense_form(cols, _aligned(dout, z, dz if gelu else None), backward=True)
    dbias = workspace = None
    if need_dbias:
        # the kernel picks its slabs of rows (from the rows, the width and
        # the card, which fixes the sum's order) and the scratch they take
        nbytes = _scratch_bytes("proqa_dense_epilogue_bwd_workspace", rows, cols, int(gelu),
                                device.index)
        dbias = torch.empty(cols, dtype=torch.float32, device=device)
        workspace = _workspace(device, nbytes)
    _build.launch("proqa_dense_epilogue_bwd", device, dout.data_ptr(), _ptr(z),
                  _ptr(dz) if gelu and need_dz else None, _ptr(workspace), _ptr(dbias), rows,
                  cols, int(dout.dtype == torch.bfloat16), int(gelu),
                  DENSE_BWD_FORMS.index(form))
    _count("F1 backward", form)
    return dz, dbias


def _add_layer_norm_kernel(x, residual, scale, bias, eps, save_stats=False):
    """F2; with save_stats also each row's f32 mean and rstd [x.shape[:-1]]."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"add_layer_norm kernel takes bf16 or f32, got {x.dtype}")
    if residual is not None and (residual.dtype != x.dtype or residual.shape != x.shape
                                 or residual.device != x.device):
        raise ValueError(f"add_layer_norm: residual {residual.dtype} {tuple(residual.shape)} "
                         f"does not match x {x.dtype} {tuple(x.shape)}")
    h = x.shape[-1]
    _check_params("add_layer_norm", h, x.device, scale, bias)
    x, scale, bias = x.contiguous(), scale.contiguous(), bias.contiguous()
    residual = None if residual is None else residual.contiguous()
    out = torch.empty_like(x)
    mean = rstd = None
    if save_stats:
        mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    form = layer_norm_form(h, x.dtype, _aligned(x, residual, scale, bias, out))
    if out.numel():
        _build.launch("proqa_add_layer_norm", x.device, x.data_ptr(), _ptr(residual),
                      scale.data_ptr(), bias.data_ptr(), out.data_ptr(), _ptr(mean), _ptr(rstd),
                      x.numel() // h, h, eps, int(x.dtype == torch.bfloat16),
                      LN_FORMS.index(form))
        _count("F2", form)
    return out, mean, rstd


def _add_layer_norm_backward_kernel(dy, x, residual, mean, rstd, scale, need_dx, need_params):
    """F2's backward on the card: (dx, dscale, dbias) as
    add_layer_norm_backward_reference, None where not needed."""
    h = x.shape[-1]
    dy = dy.contiguous()
    _check_like("add_layer_norm backward", "dy", dy, x)
    _check_params("add_layer_norm backward", h, x.device, scale)
    if not (need_dx or need_params):
        return None, None, None
    dx = torch.empty_like(x) if need_dx else None
    rows = x.numel() // h
    device = x.device
    form = layer_norm_form(h, x.dtype, _aligned(dy, x, residual, dx, scale), backward=True)
    dparams = workspace = None
    if need_params:
        nbytes = _scratch_bytes("proqa_add_layer_norm_bwd_workspace", rows, h,
                                int(x.dtype == torch.bfloat16), device.index)
        dparams = torch.empty(2, h, dtype=torch.float32, device=device)
        workspace = _workspace(device, nbytes)
    _build.launch("proqa_add_layer_norm_bwd", device, dy.data_ptr(), x.data_ptr(),
                  _ptr(residual), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), _ptr(dx),
                  _ptr(workspace), _ptr(dparams), rows, h, int(x.dtype == torch.bfloat16),
                  LN_BWD_FORMS.index(form))
    _count("F2 backward", form)
    if dparams is None:
        return dx, None, None
    return dx, dparams[0], dparams[1]


def _swiglu_kernel(y):
    """F1's SwiGLU form on the card."""
    if y.dtype not in _DTYPES:
        raise TypeError(f"swiglu kernel takes bf16 or f32, got {y.dtype}")
    if y.shape[-1] % 2:
        raise ValueError(f"swiglu: {y.shape[-1]} columns do not split into gate and up")
    cols = y.shape[-1] // 2
    y = y.contiguous()
    out = torch.empty(*y.shape[:-1], cols, dtype=y.dtype, device=y.device)
    form = dense_form(cols, _aligned(y, out), swiglu=True)
    if out.numel():
        _build.launch("proqa_dense_swiglu", y.device, y.data_ptr(), out.data_ptr(),
                      out.numel() // cols, cols, int(y.dtype == torch.bfloat16),
                      DENSE_FORMS.index(form))
        _count("F1", form)
    return out


def _add_rms_norm_kernel(x, residual, scale, eps):
    """F2's RMSNorm form on the card: (out, s)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"add_rms_norm kernel takes bf16 or f32, got {x.dtype}")
    if residual is not None:
        _check_like("add_rms_norm", "residual", residual, x)
    h = x.shape[-1]
    if scale.dtype != x.dtype or scale.shape != (h,) or scale.device != x.device:
        raise ValueError(f"add_rms_norm: scale must be {x.dtype} [{h}] on {x.device}, got "
                         f"{scale.dtype} {tuple(scale.shape)} on {scale.device}")
    x, scale = x.contiguous(), scale.contiguous()
    residual = None if residual is None else residual.contiguous()
    out = torch.empty_like(x)
    s = x if residual is None else torch.empty_like(x)
    form = layer_norm_form(h, x.dtype, _aligned(x, residual, scale, out, s), rms=True)
    if out.numel():
        _build.launch("proqa_add_rms_norm", x.device, x.data_ptr(), _ptr(residual),
                      scale.data_ptr(), out.data_ptr(), None if residual is None else s.data_ptr(),
                      x.numel() // h, h, eps, int(x.dtype == torch.bfloat16),
                      LN_FORMS.index(form))
        _count("F2", form)
    return out, s


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return False
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return True


# --- the routes where no graph is recorded ---

def dense_epilogue(y: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype,
                   gelu: bool = False) -> torch.Tensor:
    """round(y + bias) in out_dtype for an f32 product y [..., N] and an f32
    bias [N]; with gelu, round(gelu(that)) after it (exact GELU in f32)."""
    if _on_cpu(y):
        return dense_epilogue_reference(y, bias, out_dtype, gelu)
    _no_gradient("dense_epilogue", y, bias)
    return _dense_epilogue_kernel(y, bias, out_dtype, gelu)[0]


def add_layer_norm(x: torch.Tensor, residual: torch.Tensor | None, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm(x + residual) over the last dim, in f32, rounded to x's
    dtype; the sum is rounded to x's dtype first. residual may be None."""
    if _on_cpu(x):
        return add_layer_norm_reference(x, residual, scale, bias, eps)
    _no_gradient("add_layer_norm", x, residual, scale, bias)
    return _add_layer_norm_kernel(x, residual, scale, bias, eps)[0]


def swiglu(y: torch.Tensor) -> torch.Tensor:
    """round(silu(gate) * up) in f32, [..., I], of y [..., 2 I]: the gate
    product in its first I columns and the up product in the rest, in the
    activation dtype."""
    if _on_cpu(y):
        return swiglu_reference(y)
    _no_gradient("swiglu", y)
    return _swiglu_kernel(y)


def add_rms_norm(x: torch.Tensor, residual: torch.Tensor | None, scale: torch.Tensor,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm(x + residual) over the last dim, in f32 with a scale in x's
    dtype, rounded to x's dtype; the sum is rounded to x's dtype first.
    Returns (the normalised rows, the sum), the sum being x itself without a
    residual."""
    if _on_cpu(x):
        return add_rms_norm_reference(x, residual, scale, eps)
    _no_gradient("add_rms_norm", x, residual, scale)
    return _add_rms_norm_kernel(x, residual, scale, eps)


# --- the routes where a graph is recorded ---

class _Dense(torch.autograd.Function):
    """dot_f32(x, kernel), then F1. Saves x, the kernel and (with GELU) the
    rounded pre-activation z; backward runs F1's backward kernel and then the
    two products as dot_f32's backward forms them (ops/dot.py)."""

    @staticmethod
    def forward(ctx, x, kernel, bias, out_dtype, gelu):
        y = product_f32(x, kernel)
        if _on_cpu(y):
            out, z = _dense_epilogue_plain(y, bias, out_dtype, gelu)
        else:
            out, z = _dense_epilogue_kernel(y, bias, out_dtype, gelu, save_z=True)
        ctx.gelu = gelu
        ctx.save_for_backward(x, kernel, z if gelu else None)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, kernel, z = ctx.saved_tensors
        need_x, need_kernel, need_bias = ctx.needs_input_grad[:3]
        need_dz = need_x or need_kernel
        if _on_cpu(dout):
            dz, dbias = dense_epilogue_backward_reference(dout, z, ctx.gelu, need_bias)
        else:
            dz, dbias = _dense_epilogue_backward_kernel(dout, z, ctx.gelu, need_dz, need_bias)
        dx = dkernel = None
        if need_dz:
            dx, dkernel = dot_f32_backward(x, kernel, dz, need_x, need_kernel)
        return dx, dkernel, dbias, None, None


class _AddLayerNorm(torch.autograd.Function):
    """F2, saving x, the residual, the scale and each row's mean and rstd;
    backward runs F2's backward kernel, whose one dx goes to x and to the
    residual."""

    @staticmethod
    def forward(ctx, x, residual, scale, bias, eps):
        if _on_cpu(x):
            out, mean, rstd = _layer_norm_plain(x, residual, scale, bias, eps)
        else:
            out, mean, rstd = _add_layer_norm_kernel(x, residual, scale, bias, eps,
                                                     save_stats=True)
        ctx.save_for_backward(x, residual, scale, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, residual, scale, mean, rstd = ctx.saved_tensors
        need_x, need_res, need_scale, need_bias = ctx.needs_input_grad[:4]
        need_params = need_scale or need_bias
        if _on_cpu(dy):
            dx, dscale, dbias = add_layer_norm_backward_reference(dy, x, residual, mean, rstd,
                                                                  scale, need_params)
        else:
            dx, dscale, dbias = _add_layer_norm_backward_kernel(
                dy, x, residual, mean, rstd, scale, need_x or need_res, need_params)
        return (dx if need_x else None, dx if need_res else None,
                dscale if need_scale else None, dbias if need_bias else None, None)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype,
          gelu: bool = False) -> torch.Tensor:
    """A dense layer where autograd records a graph: round(x @ kernel + bias)
    in out_dtype, the product in f32 (dot_f32) and the kernel in x's dtype;
    with gelu, round(gelu(that)). Its gradient is the plain chain's
    (F1's backward kernel, then dot_f32's products)."""
    if _EAGER:
        return dense_epilogue_reference(dot_f32(x, kernel), bias, out_dtype, gelu)
    return _Dense.apply(x, kernel, bias, out_dtype, gelu)


def add_layer_norm_grad(x: torch.Tensor, residual: torch.Tensor | None, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float) -> torch.Tensor:
    """add_layer_norm where autograd records a graph, with F2's backward
    kernel for its gradient."""
    if _EAGER:
        return add_layer_norm_reference(x, residual, scale, bias, eps)
    return _AddLayerNorm.apply(x, residual, scale, bias, eps)
