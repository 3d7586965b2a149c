"""Low-precision value-table storage: per-row symmetric quantization (torch
counterpart of `repro.quant`).

  * **int8** — per-row fp32 scale ``s_r = max|v_r| / 127``; the stored row
    is ``round(v_r / s_r)`` (half to even, clipped to ±127), or with an
    `rng` the unbiased stochastic rounding ``floor(v_r / s_r + u)``,
    ``u ~ U[0, 1)`` drawn as ``rng.random(shape, dtype=float32)``: the
    tiered store's training write-back requantizes with it, so updates
    smaller than one step survive in expectation.
  * **fp8** — ``float8_e4m3fn`` payload with per-row scale
    ``max|v_r| / 448``.  On the host a payload is raw bytes (``uint8``);
    `as_torch_payload` views them as ``torch.float8_e4m3fn``.  No
    `ml_dtypes` is needed.

The order of operations and of the random draws is the reference's
(``x / scale``, round, clip), so payloads and scales are bit-equal to it
for the same generator state.  Gathers dequantize in
registers: the weight is multiplied by the row's scale and the 1-byte row
is read as fp32 (`repro_torch.kernels.gather_interp.gather_interp_quant`).
`int8_qdq` is the same int8 grid with one scale for a whole tensor, the
gradient codec's (`repro_torch.optim.compression`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

QUANT_KINDS = ("int8", "fp8")

_EPS = 1e-12
_QMAX = {"int8": 127.0, "fp8": 448.0}  # float8_e4m3fn max finite
_TORCH_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def check_kind(kind: str) -> str:
    if kind not in QUANT_KINDS:
        raise ValueError(f"unknown quant kind {kind!r}; known: {QUANT_KINDS}")
    return kind


def storage_dtype(kind: str) -> np.dtype:
    """numpy dtype of a host payload: int8, or uint8 bytes holding e4m3."""
    check_kind(kind)
    return np.dtype(np.int8) if kind == "int8" else np.dtype(np.uint8)


def torch_dtype(kind: str) -> torch.dtype:
    """torch dtype of a payload: torch.int8 or torch.float8_e4m3fn."""
    return _TORCH_DTYPE[check_kind(kind)]


def qmax(kind: str) -> float:
    return _QMAX[check_kind(kind)]


def bytes_per_entry(m: int, kind: str | None) -> int:
    """Storage bytes for one (m,)-row: payload + per-row fp32 scale."""
    if kind in (None, "none"):
        return 4 * m
    check_kind(kind)
    return m + 4


def as_torch_payload(q: np.ndarray) -> torch.Tensor:
    """A host payload as a torch tensor of its storage type (shares
    memory): int8 stays int8, uint8 bytes are viewed as float8_e4m3fn."""
    t = torch.from_numpy(np.ascontiguousarray(q))
    if t.dtype == torch.uint8:
        return t.view(torch.float8_e4m3fn)
    if t.dtype != torch.int8:
        raise TypeError(f"payload must be int8 or uint8 (e4m3 bytes), got "
                        f"{q.dtype}")
    return t


# ---------------------------------------------------------------------------
# numpy (host side: tiered shards, conversion)
# ---------------------------------------------------------------------------

def quantize_int8(x: np.ndarray, *, axis=None, rng=None):
    """Symmetric int8 quantization: (q int8, scale).

    axis=None -> one scale for the whole array; axis=-1 -> one per row.
    rng -> stochastic rounding (unbiased); None rounds to nearest.
    """
    x = np.asarray(x, np.float32)
    amax = np.abs(x).max(axis=axis, keepdims=axis is not None)
    scale = np.maximum(amax, _EPS) / 127.0
    y = x / scale
    if rng is None:
        q = np.rint(y)
    else:
        q = np.floor(y + rng.random(y.shape, dtype=np.float32))
    q = np.clip(q, -127, 127).astype(np.int8)
    return q, np.squeeze(scale, axis) if axis is not None else float(scale)


def quantize_rows_np(v: np.ndarray, kind: str, *, rng=None):
    """Per-row quantization of (..., m) values -> (q, scale (...,)).

    int8 rounds stochastically with an `rng`; fp8 always rounds to
    nearest (its grid is not uniform) and ignores it."""
    check_kind(kind)
    v = np.asarray(v, np.float32)
    if kind == "int8":
        return quantize_int8(v, axis=-1, rng=rng)
    amax = np.abs(v).max(axis=-1)
    scale = (np.maximum(amax, _EPS) / _QMAX["fp8"]).astype(np.float32)
    y = np.ascontiguousarray(v / scale[..., None])
    q = torch.from_numpy(y).to(torch.float8_e4m3fn).view(torch.uint8)
    return q.numpy(), scale


def dequantize_rows_np(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """fp32 rows from (q (..., m), scale (...,)); uint8 payloads are e4m3."""
    rows = as_torch_payload(q).float().numpy()
    return rows * np.asarray(scale, np.float32)[..., None]


# ---------------------------------------------------------------------------
# bfloat16 rows on the host: numpy has no bfloat16 and the port imports no
# ml_dtypes, so a host array of bf16 values holds their raw bits as uint16
# (the reference's ml_dtypes.bfloat16 arrays hold the same bytes)
# ---------------------------------------------------------------------------

def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """The fp32 values of bf16 raw bits (uint16, or the reference's `V2`
    / bfloat16 bytes): exact."""
    bits = np.ascontiguousarray(bits).view(np.uint16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16(x) -> np.ndarray:
    """The bf16 raw bits (uint16) of fp32 values, rounded to nearest even
    (torch's cast, as numpy's astype(bfloat16) under ml_dtypes)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's raw bits on the host (uint16), a copy."""
    return t.detach().cpu().view(torch.int16).numpy().view(np.uint16).copy()


def is_bf16_bits(a: np.ndarray) -> bool:
    """A host array of bf16 raw bits: uint16, or the reference's 2-byte
    void type (`V2`, a bfloat16 `.npy` loaded without ml_dtypes)."""
    return a.dtype == np.uint16 or (a.dtype.kind == "V"
                                    and a.dtype.itemsize == 2)


def host_rows_f32(rows: np.ndarray) -> np.ndarray:
    """fp32 rows from a host array of fp32 values or bf16 bits."""
    if is_bf16_bits(rows):
        return bf16_to_f32(rows)
    return np.asarray(rows, np.float32)


# ---------------------------------------------------------------------------
# torch (device side: dense quantized tables)
# ---------------------------------------------------------------------------

def take_rows(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """q[rows] as fp32 for any payload type.  An fp8 payload is indexed
    through its bytes: not every device's indexing takes float8."""
    if q.dtype == torch.float8_e4m3fn:
        return q.view(torch.uint8)[rows].view(torch.float8_e4m3fn).float()
    return q[rows].float()


def int8_qdq(x: torch.Tensor, amax: torch.Tensor | None = None
             ) -> torch.Tensor:
    """Symmetric int8 quantize -> dequantize with one scale for the whole
    tensor (the reference's `int8_qdq`): what survives an int8 wire
    format, on the table storage's grid.  `amax` is the largest |x| the
    scale is taken from (default `x`'s own; the gradient codec passes the
    maximum over the ranks that hold the other parts of a split leaf)."""
    amax = x.abs().max() if amax is None else amax
    scale = torch.clamp(amax, min=_EPS) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale.float()[..., None]


class QuantizedTable(nn.Module):
    """A dense (N, m) value table stored quantized with per-row scales.

    Sits at an LRAM layer's `values` in place of the fp32 `Parameter`.  Its
    payload `q` (int8 or float8_e4m3fn) and `scale` (N,) fp32 are buffers,
    so `.to(device)` moves them and the state_dict carries them.  It is a
    frozen lookup store: nothing trains it.
    """

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, kind: str):
        super().__init__()
        if q.dtype != torch_dtype(kind):
            raise TypeError(f"{kind} payload must be {torch_dtype(kind)}, "
                            f"got {q.dtype}")
        if scale.shape != q.shape[:1]:
            raise ValueError(f"scale {tuple(scale.shape)} does not match "
                             f"payload {tuple(q.shape)}")
        self.kind = kind
        self.register_buffer("q", q)
        self.register_buffer("scale", scale.float())

    @property
    def num_rows(self) -> int:
        return self.q.shape[0]

    @property
    def m(self) -> int:
        return self.q.shape[-1]

    def dequantize(self) -> torch.Tensor:
        return dequantize_rows(self.q, self.scale)

    @classmethod
    def from_payload(cls, q: np.ndarray, scale: np.ndarray,
                     kind: str) -> "QuantizedTable":
        """The table holding exactly this payload and these scales."""
        return cls(as_torch_payload(np.array(q, copy=True)),
                   torch.from_numpy(np.array(scale, np.float32)), kind)

    @classmethod
    def from_dense(cls, values, kind: str) -> "QuantizedTable":
        q, scale = quantize_rows_np(np.asarray(values), kind)
        return cls.from_payload(q, scale, kind)


def max_abs_error_bound(scale, w, kind: str = "int8") -> float:
    """Agreement bound between a quantized lookup and its fp32 twin:
    |out_q - out_fp32| <= sum_k |w_k| * max_r(scale_r) * h, with h the
    grid's half-step in scale units: 1/2 for int8, 448 * 2**-4 = 28 for
    fp8 (e4m3 rounds within 2**-4 of a magnitude that reaches 448)."""
    half_step = 0.5 if check_kind(kind) == "int8" else _QMAX["fp8"] / 16.0
    w = torch.as_tensor(w).float()
    scale = torch.as_tensor(scale).float()
    return float(w.abs().sum(-1).max() * scale.max() * half_step)
