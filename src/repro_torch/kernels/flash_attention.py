"""Launcher of the CUDA `flash_attention` kernel (csrc/flash_attention.cu).

Counterpart of the Pallas kernel in `repro.kernels.flash_attention`:
softmax(q k^T * scale + mask) v with an online softmax, q (B, H, Sq, hd),
k and v (B, KV, Sk, hd), GQA, causal / sliding-window / kv-padding masks,
f32 statistics, 0 for a fully masked row.  It also takes `q_offset` (B,)
int32, the position of each sequence's first query (0 without it), which
the reference kernel lacks; the plain version is `ref.attention_ref`.

Calls with at most SPLIT_ROWS query rows per kv head (Sq * H / KV: every
decode step) split each sequence's kv range across blocks: the split kernel
writes f32 partials (m, l, acc) to scratch allocated here, and a second
launch, `flash_combine`, merges them by log-sum-exp (plain versions
`ref.flash_split_ref` and `ref.flash_combine_ref`).  The number of splits is
a function of static shapes only (`split_plan`); no offset is read back to
the host.  Longer calls run 64-row tiles: bf16 on the tensor cores, f32 on
the CUDA cores.

q, k and v go in through element strides: only the head dim must be
contiguous, so the transposed view of a (B, S, KV, hd) KV cache is read in
place.  Rows must start on 16 bytes (base pointers and the batch, head and
sequence strides in whole 16-byte words), which every tensor the model
passes satisfies.  The output has q's layout.  f32 and bf16; hd in
HEAD_DIMS.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 80, 128)
SPLIT_ROWS = 16          # query rows of one kv head in a split-KV tile
MAX_SPLITS = 64
SPLIT_TILE = 64          # kv rows per tile; a chunk is a multiple of it
SPLIT_FILL = 4           # blocks per SM that split_plan aims for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_sm_counts: dict[int, int] = {}


def split_plan(Sk: int, B: int, KV: int, sms: int) -> tuple[int, int]:
    """(splits, chunk) for a split-KV call: split s covers kv rows
    [s * chunk, min((s + 1) * chunk, Sk)), a multiple of SPLIT_TILE rows,
    and B * KV * splits blocks fill `sms` SMs SPLIT_FILL times, at most one
    split per tile and MAX_SPLITS.  Static shapes only: no offset is read,
    so the launcher never waits for the card."""
    tiles = max(1, -(-Sk // SPLIT_TILE))
    want = max(1, -(-SPLIT_FILL * sms // max(1, B * KV)))
    splits = min(want, tiles, MAX_SPLITS)
    chunk = -(-tiles // splits) * SPLIT_TILE
    return max(1, -(-Sk // chunk)), chunk


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _aligned(t: torch.Tensor) -> bool:
    words = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s % words == 0 for s in t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    q_offset: torch.Tensor | None = None) -> torch.Tensor:
    name = "flash_attention"
    tensors = [q, k, v] + ([q_offset] if q_offset is not None else [])
    dev = q.device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"{name}: expected CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: expected q (B, H, Sq, hd) and k, v "
                         f"(B, KV, Sk, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} (H must be a multiple of KV)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if any(t.stride(3) != 1 or not _aligned(t) for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v need a contiguous head dim and "
                         f"rows on 16-byte boundaries")
    if q_offset is not None and (q_offset.dtype != torch.int32
                                 or q_offset.shape != (B,)
                                 or not q_offset.is_contiguous()):
        raise ValueError(f"{name}: q_offset must be contiguous ({B},) int32, "
                         f"got {tuple(q_offset.shape)} {q_offset.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")
    out = torch.empty_like(q)           # q's strides when q is dense
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else hd ** -0.5
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    off = q_offset.data_ptr() if q_offset is not None else None
    P, I = _build.P, _build.I
    if Sq * (H // KV) <= SPLIT_ROWS:
        splits, chunk = split_plan(Sk, B, KV, _sm_count(dev))
        ml = torch.empty((B, KV, splits, SPLIT_ROWS, 2), dtype=torch.float32,
                         device=dev)
        acc = torch.empty((B, KV, splits, SPLIT_ROWS, hd),
                          dtype=torch.float32, device=dev)
        fn = _build.function(name, "flash_attention_split",
                             (P, P, P, P, I, I, I, I, I, I, I, I, I,
                              ctypes.c_float, P, I, I, P, P, P))
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), off,
                        _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd, int(causal),
                        int(window) if window is not None else 0, scale,
                        ctypes.cast(strides, ctypes.c_void_p), splits, chunk,
                        ml.data_ptr(), acc.data_ptr(), _build.stream(q)),
                     name)
        _build.LAUNCHES[name] += 1
        flash_combine(ml, acc, out)
        return out
    fn = _build.function(name, "flash_attention_fwd",
                         (P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                          ctypes.c_float, P, P))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    off, _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd, int(causal),
                    int(window) if window is not None else 0, scale,
                    ctypes.cast(strides, ctypes.c_void_p),
                    _build.stream(q)), name)
    _build.LAUNCHES[name] += 1
    return out


def flash_combine(ml: torch.Tensor, acc: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """Merge split-KV partials into `out` (B, H, Sq, hd), in place and
    through out's strides: ml (B, KV, splits, SPLIT_ROWS, 2) holds each
    split's row max m and sum l, acc (B, KV, splits, SPLIT_ROWS, hd) its
    unnormalised p v, both f32, for the packed rows r = i * (H / KV) + g <
    Sq * (H / KV).  Splits with l = 0 saw no key and weigh nothing; a row
    that no split saw is 0."""
    name = "flash_combine"
    dev = out.device
    if any(t.device.type != "cuda" or t.device != dev for t in (ml, acc)):
        raise ValueError(f"{name}: expected CUDA tensors on one device")
    B, H, Sq, hd = out.shape
    if ml.dim() != 5 or ml.shape[0] != B or ml.shape[3:] != (SPLIT_ROWS, 2) \
            or acc.shape != ml.shape[:4] + (hd,) or not ml.is_contiguous() \
            or not acc.is_contiguous() or ml.dtype != torch.float32 \
            or acc.dtype != torch.float32:
        raise ValueError(f"{name}: ml {tuple(ml.shape)} and acc "
                         f"{tuple(acc.shape)} do not fit out "
                         f"{tuple(out.shape)}")
    KV, splits = ml.shape[1], ml.shape[2]
    if KV == 0 or H % KV or Sq * (H // KV) > SPLIT_ROWS \
            or not 1 <= splits <= MAX_SPLITS or out.dtype not in _DTYPES \
            or out.stride(3) != 1:
        raise ValueError(f"{name}: unsupported H {H}, KV {KV}, Sq {Sq}, "
                         f"splits {splits} or output {out.dtype}")
    os_ = (ctypes.c_longlong * 3)(*out.stride()[:3])
    P, I = _build.P, _build.I
    fn = _build.function("flash_attention", "flash_attention_combine",
                         (P, P, P, I, I, I, I, I, I, I, P, P))
    _build.check(fn(ml.data_ptr(), acc.data_ptr(), out.data_ptr(),
                    _DTYPES[out.dtype], B, H, KV, Sq, hd, splits,
                    ctypes.cast(os_, ctypes.c_void_p), _build.stream(out)),
                 name)
    _build.LAUNCHES[name] += 1
    return out
