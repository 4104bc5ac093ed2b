"""Flash attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) and its wrapper.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/flash_attention.py: flash_attention`` (body
``_kernel``).  The source's header says how the design maps the TPU
kernel onto Hopper and what bounds it on the card: bf16 runs on the
tensor cores (``mma.sync``), float32 on the CUDA cores.

The wrapper takes the plain version (``kernels/ref.py``) only for tensors
that lie on the CPU.  A CUDA tensor launches the kernel or raises: a
failed build, a card other than sm_90 or a refused launch is an error,
never a switch to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 80, 96, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_supported(s_q: int, s_kv: int, n_heads: int,
                              n_kv: int, *, block: int = 128) -> bool:
    """The reference's shape gate: equal self-attention lengths that tile
    into ``min(block, S)`` blocks, GQA-divisible head counts."""
    if s_q != s_kv or n_kv <= 0 or n_heads % n_kv:
        return False
    bq = min(block, s_q)
    return s_q % bq == 0


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _check_sm90(index: int) -> None:
    if torch.cuda.get_device_capability(index) != (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(index)} is not sm_90; the "
            f"kernel is built for Hopper (sm_90a) only")


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,S,H,hd], k/v [B,S,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (self-attention, same hd)")
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} not divisible by kv heads "
                         f"{k.shape[2]} (GQA grouping)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                         f"kernel takes float32 or bfloat16, all alike")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous [B,S,heads,hd] "
                         "tensors")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("the bf16 kernel copies 16-byte pieces: q, k and "
                         "v must start on 16-byte boundaries")
    _check_sm90(q.device.index if q.device.index is not None
                else torch.cuda.current_device())
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash kernel has no backward of its own: differentiate "
            "through kernels/ops.py: flash_attention_vjp")


def flash_attention(q, k, v, *, causal: bool = True):
    """q [B, S, H, hd]; k, v [B, S, KV, hd] -> [B, S, H, hd].

    CPU tensors: the plain version.  CUDA tensors: the CUDA kernel, on
    the current stream, counted in ``flash_attention.launches``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    _check(q, k, v)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2], hd, int(bool(causal)),
            _DTYPE_CODES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError "
                           f"{err} for q {tuple(q.shape)} {q.dtype}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# --- the kernel as a dispatcher operator ------------------------------------
# ``kernels/ops.py: flash_attention_vjp`` calls it: its CUDA implementation
# is the kernel, its CPU one the plain version (both through the wrapper),
# its fake one gives a meta tensor its shape (the dry run,
# ``launch/dryrun.py``), and ``FlopCounterMode`` counts it on every device.

@torch.library.custom_op(
    "repro_torch::flash_attention", mutates_args=(),
    device_types=("cpu", "cuda"),
    schema="(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor")
def _flash_attention_op(q, k, v, causal):
    return flash_attention(q, k, v, causal=causal)


@_flash_attention_op.register_fake
def _(q, k, v, causal):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q, k, v, causal, *args, out_shape=None, **kw):
    """4·B·H·S·S_kv·hd: the scores and the weighted values, causal or
    not, as torch counts ``scaled_dot_product_attention`` (and as the
    plain version's two products come to)."""
    B, S, H, hd = q
    return 4 * B * H * S * k[1] * hd
