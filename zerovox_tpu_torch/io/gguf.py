"""GGUF container reader / writer (pure Python, numpy-backed).

The port's own copy of zerovox_tpu/io/gguf.py (the port imports nothing of
the JAX package).  Same on-disk format as the reference's vendored C
implementation: little-endian header (magic "GGUF", version), typed
key/value metadata, named tensor directory, aligned data blob.

The reader memory-maps the file and returns zero-copy numpy views (every
quantized type is dequantized in numpy); the writer produces files the JAX
package, the reference binary and the upstream `gguf` package all read.
"""

from __future__ import annotations

import enum
import mmap
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGMLType(enum.IntEnum):
    """ggml tensor dtypes (ggml/include/ggml.h enum ggml_type)."""
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


# (block_size_elems, bytes_per_block) for each supported type.
_TYPE_TRAITS: Dict[int, Tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18),
    GGMLType.Q4_1: (32, 20),
    GGMLType.Q5_0: (32, 22),
    GGMLType.Q5_1: (32, 24),
    GGMLType.Q8_0: (32, 34),
    # K-quants: 256-element super-blocks (ggml-common.h block_q*_K structs).
    # All six stored K-quants read and dequantize; Q8_K (an un-stored
    # intermediate of ggml's matmul path, quantize_row_q8_K) reads too so a
    # file that stores one is not a hard error.  Every dequantizer is
    # differential-tested against the compiled vendored ggml runtime's
    # to_float on ggml-quantized data (in the JAX package's tests).
    GGMLType.Q2_K: (256, 84),
    GGMLType.Q3_K: (256, 110),
    GGMLType.Q4_K: (256, 144),
    GGMLType.Q5_K: (256, 176),
    GGMLType.Q6_K: (256, 210),
    GGMLType.Q8_K: (256, 292),
}

_NUMPY_DTYPES: Dict[int, np.dtype] = {
    GGMLType.F32: np.dtype(np.float32),
    GGMLType.F16: np.dtype(np.float16),
    GGMLType.F64: np.dtype(np.float64),
    GGMLType.I8: np.dtype(np.int8),
    GGMLType.I16: np.dtype(np.int16),
    GGMLType.I32: np.dtype(np.int32),
    GGMLType.I64: np.dtype(np.int64),
    # BF16 handled specially (viewed as uint16, widened on demand).
}

_NP_TO_GGML = {
    np.dtype(np.float32): GGMLType.F32,
    np.dtype(np.float16): GGMLType.F16,
    np.dtype(np.float64): GGMLType.F64,
    np.dtype(np.int8): GGMLType.I8,
    np.dtype(np.int16): GGMLType.I16,
    np.dtype(np.int32): GGMLType.I32,
    np.dtype(np.int64): GGMLType.I64,
}


class GGUFValueType(enum.IntEnum):
    """GGUF metadata value types (gguf_type in ggml.h)."""
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def dequantize_q8_0(raw: np.ndarray, nelements: int) -> np.ndarray:
    """Q8_0: blocks of 32 elems = f16 scale + 32 int8 (ggml-quants semantics:
    x = q * scale)."""
    blocks = raw.reshape(-1, 34)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (qs * scales).reshape(-1)[:nelements]


def dequantize_q4_0(raw: np.ndarray, nelements: int) -> np.ndarray:
    """Q4_0: blocks of 32 elems = f16 scale + 16 bytes of nibbles
    (x_i = (nib_i - 8) * scale; low nibbles are elements 0-15)."""
    blocks = raw.reshape(-1, 18)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    nibs = blocks[:, 2:]
    lo = (nibs & 0x0F).astype(np.int8) - 8
    hi = (nibs >> 4).astype(np.int8) - 8
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * scales
    return out.reshape(-1)[:nelements]


def dequantize_q4_1(raw: np.ndarray, nelements: int) -> np.ndarray:
    """Q4_1: blocks of 32 = f16 scale d + f16 min m + 16 nibble bytes
    (x_i = nib_i * d + m; low nibbles are elements 0-15).
    Matches ggml/src/ggml-quants.c dequantize_row_q4_1."""
    blocks = raw.reshape(-1, 20)
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    nibs = blocks[:, 4:]
    lo = (nibs & 0x0F).astype(np.float32)
    hi = (nibs >> 4).astype(np.float32)
    out = np.concatenate([lo, hi], axis=1) * d + m
    return out.reshape(-1)[:nelements]


def _q5_quants(blocks: np.ndarray, qh_off: int) -> np.ndarray:
    """Shared Q5_0/Q5_1 5-bit reconstruction: 4-bit nibbles + a 32-bit
    high-bit word per block; element j takes qh bit j (low nibbles are
    elements 0-15, high nibbles 16-31)."""
    qh = blocks[:, qh_off:qh_off + 4].copy().view(np.uint32)  # (nb, 1)
    nibs = blocks[:, qh_off + 4:]
    bit = np.arange(16, dtype=np.uint32)
    hi0 = ((qh >> bit) & 1).astype(np.uint8) << 4           # elements 0-15
    hi1 = ((qh >> (bit + 16)) & 1).astype(np.uint8) << 4    # elements 16-31
    lo = (nibs & 0x0F) | hi0
    hi = (nibs >> 4) | hi1
    return np.concatenate([lo, hi], axis=1).astype(np.float32)


def dequantize_q5_0(raw: np.ndarray, nelements: int) -> np.ndarray:
    """Q5_0: f16 scale + 4-byte high bits + 16 nibble bytes
    (x_i = (q5_i - 16) * d).  Matches ggml-quants.c dequantize_row_q5_0."""
    blocks = raw.reshape(-1, 22)
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    q = _q5_quants(blocks, qh_off=2) - 16.0
    return (q * d).reshape(-1)[:nelements]


def dequantize_q5_1(raw: np.ndarray, nelements: int) -> np.ndarray:
    """Q5_1: f16 scale + f16 min + 4-byte high bits + 16 nibble bytes
    (x_i = q5_i * d + m).  Matches ggml-quants.c dequantize_row_q5_1."""
    blocks = raw.reshape(-1, 24)
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    q = _q5_quants(blocks, qh_off=4)
    return (q * d + m).reshape(-1)[:nelements]


def _f16_col(blocks: np.ndarray, off: int) -> np.ndarray:
    """One little-endian f16 per block at byte offset `off`, as (nb,) f32."""
    return (blocks[:, off:off + 2].copy().view(np.float16)
            .astype(np.float32).reshape(-1))


def dequantize_q2_k(raw: np.ndarray, nelements: int) -> np.ndarray:
    """Q2_K: 256-elem super-block = 16 packed 4|4-bit (scale|min) bytes,
    64 bytes of 2-bit quants, f16 d, f16 dmin
    (x = d*(sc&0xF)*q2 - dmin*(sc>>4), 16 groups of 16).
    Matches ggml/src/ggml-quants.c dequantize_row_q2_K."""
    blocks = raw.reshape(-1, 84)
    nb = blocks.shape[0]
    sc = blocks[:, :16].reshape(nb, 2, 4, 2)         # (half, shift, sub)
    qs = blocks[:, 16:80].reshape(nb, 2, 1, 2, 16)   # (half, -, sub, lane)
    d = _f16_col(blocks, 80)[:, None, None, None]
    dmin = _f16_col(blocks, 82)[:, None, None, None]
    shifts = np.arange(0, 8, 2, dtype=np.uint8).reshape(1, 1, 4, 1, 1)
    q = ((qs >> shifts) & 3).astype(np.float32)      # (nb, 2, 4, 2, 16)
    dl = d * (sc & 0xF).astype(np.float32)
    ml = dmin * (sc >> 4).astype(np.float32)
    y = dl[..., None] * q - ml[..., None]
    return y.reshape(-1)[:nelements]


def dequantize_q3_k(raw: np.ndarray, nelements: int) -> np.ndarray:
    """Q3_K: 256-elem super-block = 32 high-bit-mask bytes, 64 bytes of
    2-bit low quants, 12 bytes of packed 6-bit group scales, f16 d
    (x = d*(sc-32)*(q3 - 4*!hbit), 16 groups of 16).
    Matches ggml/src/ggml-quants.c dequantize_row_q3_K
    (the kmask scale unpack is reproduced per byte)."""
    blocks = raw.reshape(-1, 110)
    nb = blocks.shape[0]
    hm = blocks[:, :32].reshape(nb, 1, 1, 2, 16)     # (half*shift bit picks)
    qs = blocks[:, 32:96].reshape(nb, 2, 1, 2, 16)
    sb = blocks[:, 96:108]                           # packed 6-bit scales
    d = _f16_col(blocks, 108)[:, None, None, None]
    # byte j of the unpacked 16: low 4 bits from sb[j]&0xF (j<8) or
    # sb[j-8]>>4 (j>=8); high 2 bits from sb[8 + j%4] >> (2*(j//4))
    lo4 = np.concatenate([sb[:, :8] & 0xF, sb[:, :8] >> 4], axis=1)
    j = np.arange(16)
    hi2 = (sb[:, 8 + j % 4] >> (2 * (j // 4)).astype(np.uint8)) & 3
    sc6 = (lo4 | (hi2 << 4)).astype(np.float32) - 32.0
    sc6 = sc6.reshape(nb, 2, 4, 2)
    shifts = np.arange(0, 8, 2, dtype=np.uint8).reshape(1, 1, 4, 1, 1)
    q = ((qs >> shifts) & 3).astype(np.float32)
    bit = (np.arange(2)[:, None] * 4 + np.arange(4)).astype(np.uint8)
    hbit = (hm >> bit.reshape(1, 2, 4, 1, 1)) & 1    # (nb, 2, 4, 2, 16)
    q = q - np.where(hbit, 0.0, 4.0).astype(np.float32)
    y = (d * sc6)[..., None] * q
    return y.reshape(-1)[:nelements]


def _kscale_min6(sb: np.ndarray):
    """Unpack the 12-byte packed 6-bit (scale, min) table shared by Q4_K /
    Q5_K (ggml-quants.c get_scale_min_k4): 8 pairs, j<4 straight 6-bit
    fields, j>=4 split across the nibble bytes + top bits of the first 8."""
    nb = sb.shape[0]
    sc = np.empty((nb, 8), np.float32)
    mn = np.empty((nb, 8), np.float32)
    sc[:, :4] = (sb[:, :4] & 63).astype(np.float32)
    mn[:, :4] = (sb[:, 4:8] & 63).astype(np.float32)
    sc[:, 4:] = ((sb[:, 8:12] & 0xF) | ((sb[:, :4] >> 6) << 4)).astype(np.float32)
    mn[:, 4:] = ((sb[:, 8:12] >> 4) | ((sb[:, 4:8] >> 6) << 4)).astype(np.float32)
    return sc.reshape(nb, 4, 2), mn.reshape(nb, 4, 2)


def dequantize_q4_k(raw: np.ndarray, nelements: int) -> np.ndarray:
    """Q4_K: 256-elem super-block = f16 d, f16 dmin, 12 packed scale/min
    bytes, 128 nibble bytes (x = d*sc[g]*nib - dmin*mn[g], 8 groups of 32;
    low nibbles are the even groups).
    Matches ggml/src/ggml-quants.c dequantize_row_q4_K."""
    blocks = raw.reshape(-1, 144)
    nb = blocks.shape[0]
    d = _f16_col(blocks, 0)[:, None, None]
    dmin = _f16_col(blocks, 2)[:, None, None]
    sc, mn = _kscale_min6(blocks[:, 4:16])
    nibs = blocks[:, 16:].reshape(nb, 4, 32)
    q = np.stack([nibs & 0xF, nibs >> 4], axis=2).astype(np.float32)
    y = (d * sc)[..., None] * q - (dmin * mn)[..., None]
    return y.reshape(-1)[:nelements]


def dequantize_q5_k(raw: np.ndarray, nelements: int) -> np.ndarray:
    """Q5_K: Q4_K plus 32 high-bit bytes before the nibbles; group g takes
    qh bit g of each byte (x = d*sc[g]*(nib + 16*hbit) - dmin*mn[g]).
    Matches ggml/src/ggml-quants.c dequantize_row_q5_K."""
    blocks = raw.reshape(-1, 176)
    nb = blocks.shape[0]
    d = _f16_col(blocks, 0)[:, None, None]
    dmin = _f16_col(blocks, 2)[:, None, None]
    sc, mn = _kscale_min6(blocks[:, 4:16])
    qh = blocks[:, 16:48].reshape(nb, 1, 1, 32)
    nibs = blocks[:, 48:].reshape(nb, 4, 32)
    u = (np.arange(4)[:, None] * 2 + np.arange(2)).astype(np.uint8)
    hbit = (qh >> u.reshape(1, 4, 2, 1)) & 1
    q = (np.stack([nibs & 0xF, nibs >> 4], axis=2)
         + 16 * hbit).astype(np.float32)
    y = (d * sc)[..., None] * q - (dmin * mn)[..., None]
    return y.reshape(-1)[:nelements]


def dequantize_q8_k(raw: np.ndarray, nelements: int) -> np.ndarray:
    """Q8_K: f32 d + 256 int8 + 16 int16 group sums (sums are matmul-path
    metadata, ignored on dequant; x = d * q).
    Matches ggml/src/ggml-quants.c dequantize_row_q8_K."""
    blocks = raw.reshape(-1, 292)
    d = blocks[:, :4].copy().view(np.float32)        # (nb, 1)
    qs = blocks[:, 4:260].view(np.int8).astype(np.float32)
    return (d * qs).reshape(-1)[:nelements]


def dequantize_q6_k(raw: np.ndarray, nelements: int) -> np.ndarray:
    """Q6_K: 256-element super-blocks = ql[128] low nibbles, qh[64] 2-bit
    highs, 16 int8 group scales, f16 d (x = d * sc[g] * (q6 - 32)).
    Matches ggml/src/ggml-quants.c dequantize_row_q6_K."""
    blocks = raw.reshape(-1, 210)
    nb = blocks.shape[0]
    ql = blocks[:, :128].reshape(nb, 2, 2, 32)       # (nb, half, lo/hi32, 32)
    qh = blocks[:, 128:192].reshape(nb, 2, 32)       # (nb, half, 32)
    sc = blocks[:, 192:208].view(np.int8).reshape(nb, 2, 8).astype(np.float32)
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)  # (nb,1)

    # per half: quadrants q1..q4 of 32 elements each
    q1 = (ql[:, :, 0] & 0xF) | (((qh >> 0) & 3) << 4)
    q2 = (ql[:, :, 1] & 0xF) | (((qh >> 2) & 3) << 4)
    q3 = (ql[:, :, 0] >> 4) | (((qh >> 4) & 3) << 4)
    q4 = (ql[:, :, 1] >> 4) | (((qh >> 6) & 3) << 4)
    q = np.stack([q1, q2, q3, q4], axis=2).astype(np.float32) - 32.0  # (nb,2,4,32)

    # scale group: quadrant k, lane l -> sc[2k + l//16]
    lane_g = np.arange(32) // 16                     # (32,) in {0,1}
    quad = np.arange(4)[:, None] * 2 + lane_g[None, :]   # (4, 32) indices 0..7
    scales = sc[:, :, quad]                          # (nb, 2, 4, 32)
    y = d[:, :, None, None] * scales * q             # d broadcasts over halves
    return y.reshape(-1)[:nelements]


# Every quantized type the reader advertises in _TYPE_TRAITS has a
# dequantizer here; get() never raises on an advertised type.
_DEQUANTIZERS = {
    GGMLType.Q8_0: dequantize_q8_0,
    GGMLType.Q4_0: dequantize_q4_0,
    GGMLType.Q4_1: dequantize_q4_1,
    GGMLType.Q5_0: dequantize_q5_0,
    GGMLType.Q5_1: dequantize_q5_1,
    GGMLType.Q2_K: dequantize_q2_k,
    GGMLType.Q3_K: dequantize_q3_k,
    GGMLType.Q4_K: dequantize_q4_k,
    GGMLType.Q5_K: dequantize_q5_k,
    GGMLType.Q6_K: dequantize_q6_k,
    GGMLType.Q8_K: dequantize_q8_k,
}


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """float32 -> Q8_0 raw bytes (round-to-nearest, amax scaling like ggml)."""
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    if x.size % 32 != 0:
        raise ValueError("Q8_0 requires a multiple of 32 elements")
    groups = x.reshape(-1, 32)
    amax = np.abs(groups).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round(groups * inv[:, None]), -128, 127).astype(np.int8)
    out = np.empty((groups.shape[0], 34), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def bf16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    """Widen a uint16 bfloat16 view to float32."""
    return (raw_u16.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_u16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even cast of float32 to a uint16 bfloat16 view."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    rounding = 0x7FFF + ((u >> 16) & 1)
    return ((u + rounding) >> 16).astype(np.uint16)


@dataclass
class GGUFTensorInfo:
    name: str
    shape: Tuple[int, ...]         # numpy-order shape (outermost first)
    ggml_type: GGMLType
    offset: int                    # relative to start of data section

    @property
    def ne(self) -> Tuple[int, ...]:
        """ggml ne order: innermost dimension first."""
        return tuple(reversed(self.shape))

    @property
    def nelements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        bs, tb = _TYPE_TRAITS[self.ggml_type]
        if self.nelements % bs != 0:
            raise ValueError(f"{self.name}: {self.nelements} elems not divisible by "
                             f"block size {bs} of {self.ggml_type.name}")
        return (self.nelements // bs) * tb


class _Cursor:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("truncated GGUF file")
        self.pos += n
        return b

    def unpack(self, fmt: str):
        (v,) = struct.unpack(fmt, self.read(struct.calcsize(fmt)))
        return v

    def read_string(self) -> str:
        n = self.unpack("<Q")
        return self.read(n).decode("utf-8")


def _read_value(cur: _Cursor, vtype: int, depth: int = 0) -> Any:
    vtype = GGUFValueType(vtype)
    if vtype == GGUFValueType.STRING:
        return cur.read_string()
    if vtype == GGUFValueType.ARRAY:
        # depth cap: a crafted file nesting ARRAY-of-ARRAY thousands deep
        # would otherwise escape the sanctioned (ValueError/EOFError)
        # family as RecursionError; real checkpoints nest at most once
        if depth >= 8:
            raise ValueError("GGUF array nesting exceeds depth 8")
        elem_type = cur.unpack("<i")
        count = cur.unpack("<Q")
        return [_read_value(cur, elem_type, depth + 1) for _ in range(count)]
    return cur.unpack(_SCALAR_FMT[vtype])


class GGUFReader:
    """Parse a GGUF file; tensors are zero-copy mmap-backed numpy views."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        cur = _Cursor(self._mm)

        magic = cur.unpack("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: bad GGUF magic {magic:#x}")
        self.version = cur.unpack("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {self.version}")
        n_tensors = cur.unpack("<q")
        n_kv = cur.unpack("<q")
        if n_tensors < 0 or n_kv < 0:
            # the counts are signed on the wire (ggml reads int64); a
            # negative count would silently parse as an empty file here
            raise ValueError(f"{path}: negative section count "
                             f"(n_tensors={n_tensors}, n_kv={n_kv})")

        self.kv: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = cur.read_string()
            vtype = cur.unpack("<i")
            self.kv[key] = _read_value(cur, vtype)

        self.tensors: Dict[str, GGUFTensorInfo] = {}
        self._order: List[str] = []
        for _ in range(n_tensors):
            name = cur.read_string()
            n_dims = cur.unpack("<I")
            ne = [cur.unpack("<Q") for _ in range(n_dims)]
            ggml_type = GGMLType(cur.unpack("<i"))
            offset = cur.unpack("<Q")
            info = GGUFTensorInfo(name=name, shape=tuple(reversed(ne)),
                                  ggml_type=ggml_type, offset=offset)
            self.tensors[name] = info
            self._order.append(name)

        self.alignment = int(self.kv.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        if self.alignment <= 0 or (self.alignment & (self.alignment - 1)) != 0:
            # mirror the native reader's hardening: a corrupt alignment would
            # otherwise ZeroDivisionError below / silently misalign data
            raise ValueError(
                f"invalid general.alignment {self.alignment}: must be a "
                "positive power of two")
        pad = (self.alignment - cur.pos % self.alignment) % self.alignment
        self.data_offset = cur.pos + pad

    # ------------------------------------------------------------------ access
    def tensor_names(self) -> List[str]:
        return list(self._order)

    def get_raw(self, name: str) -> np.ndarray:
        """Raw bytes of a tensor (uint8 view) — works for every ggml type."""
        info = self.tensors[name]
        start = self.data_offset + info.offset
        nbytes = info.nbytes
        # explicit extent check: corrupt offsets/shapes must fail as
        # ValueError, not numpy's OverflowError (huge counts) or a short
        # view (found by tests/test_gguf_fuzz.py byte-flip sweep)
        if start + nbytes > len(self._mm):
            raise ValueError(
                f"{self.path}: tensor {name!r} extent [{start}, "
                f"{start + nbytes}) exceeds file size {len(self._mm)}")
        return np.frombuffer(self._mm, dtype=np.uint8, count=nbytes, offset=start)

    def get(self, name: str, as_float32: bool = False) -> np.ndarray:
        """Tensor as a numpy array in numpy-order shape.

        F32/F16/int types are zero-copy views; BF16 is widened to f32;
        quantized types raise (use get_raw + a dequantizer).
        """
        info = self.tensors[name]
        raw = self.get_raw(name)
        if info.ggml_type == GGMLType.BF16:
            arr = bf16_to_f32(raw.view(np.uint16)).reshape(info.shape)
        elif info.ggml_type in _DEQUANTIZERS:
            arr = _DEQUANTIZERS[info.ggml_type](raw, info.nelements
                                                ).reshape(info.shape)
        elif info.ggml_type in _NUMPY_DTYPES:
            arr = raw.view(_NUMPY_DTYPES[info.ggml_type]).reshape(info.shape)
        else:
            raise NotImplementedError(
                f"{name}: quantized type {info.ggml_type.name}; use get_raw()")
        if as_float32 and arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        return arr

    def load_all(self, as_float32: bool = True, copy: bool = True
                 ) -> Dict[str, np.ndarray]:
        """All tensors as a dict.  copy=True (default) detaches the arrays
        from the mmap so the reader can be closed."""
        out = {}
        for n in self._order:
            a = self.get(n, as_float32=as_float32)
            out[n] = np.array(a, copy=True) if copy and a.base is not None else a
        return out

    def close(self):
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _write_string(f, s: str):
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _infer_vtype(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        if v < 0:
            return GGUFValueType.INT32 if -(2**31) <= v else GGUFValueType.INT64
        return GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot map {type(v)} to a GGUF value type")


def _write_value(f, v: Any, vtype: Optional[GGUFValueType] = None, nested: bool = False):
    vtype = vtype or _infer_vtype(v)
    if not nested:
        f.write(struct.pack("<i", int(vtype)))
    if vtype == GGUFValueType.STRING:
        _write_string(f, v)
    elif vtype == GGUFValueType.ARRAY:
        if len(v) == 0:
            elem_t = GGUFValueType.UINT32
        else:
            elem_t = _infer_vtype(v[0])
        f.write(struct.pack("<i", int(elem_t)))
        f.write(struct.pack("<Q", len(v)))
        for item in v:
            _write_value(f, item, elem_t, nested=True)
    else:
        f.write(struct.pack(_SCALAR_FMT[vtype], v))


class GGUFWriter:
    """Write a GGUF v3 file: add_kv / add_tensor, then write(path)."""

    def __init__(self, arch: Optional[str] = None,
                 alignment: int = GGUF_DEFAULT_ALIGNMENT):
        if alignment <= 0 or (alignment & (alignment - 1)) != 0:
            raise ValueError(f"alignment must be a power of two, got {alignment}")
        self.kv: List[Tuple[str, Any, Optional[GGUFValueType]]] = []
        self.tensor_data: List[Tuple[GGUFTensorInfo, bytes]] = []
        self.alignment = alignment
        if arch is not None:
            self.add_kv("general.architecture", arch)
        if alignment != GGUF_DEFAULT_ALIGNMENT:
            self.add_uint32("general.alignment", alignment)

    def add_kv(self, key: str, value: Any, vtype: Optional[GGUFValueType] = None):
        self.kv.append((key, value, vtype))

    def add_uint32(self, key: str, value: int):
        self.add_kv(key, int(value), GGUFValueType.UINT32)

    def add_tensor(self, name: str, array: np.ndarray,
                   ggml_type: Optional[GGMLType] = None):
        array = np.ascontiguousarray(array)
        if ggml_type is None:
            ggml_type = _NP_TO_GGML[array.dtype]
        if ggml_type == GGMLType.BF16:
            data = (array.tobytes() if array.dtype == np.uint16
                    else f32_to_bf16_u16(array).tobytes())
        elif ggml_type == GGMLType.Q8_0 and array.dtype != np.uint8:
            data = quantize_q8_0(array).tobytes()
        elif ggml_type in _NUMPY_DTYPES:
            # cast to the dtype the label implies — writing f32 bytes under an
            # F16 label would silently corrupt the file
            data = array.astype(_NUMPY_DTYPES[ggml_type], copy=False).tobytes()
        else:
            raise TypeError(
                f"{name}: cannot encode dtype {array.dtype} as "
                f"{GGMLType(ggml_type).name}; use add_tensor_raw for "
                "pre-quantized block data")
        info = GGUFTensorInfo(name=name, shape=array.shape,
                              ggml_type=GGMLType(ggml_type), offset=0)
        self.tensor_data.append((info, data))

    def add_tensor_raw(self, name: str, raw: bytes, shape: Tuple[int, ...],
                       ggml_type: GGMLType):
        """Add pre-quantized block bytes with an explicit logical shape."""
        info = GGUFTensorInfo(name=name, shape=tuple(int(d) for d in shape),
                              ggml_type=GGMLType(ggml_type), offset=0)
        if info.nbytes != len(raw):
            raise ValueError(
                f"{name}: {len(raw)} raw bytes but shape {shape} of "
                f"{GGMLType(ggml_type).name} implies {info.nbytes}")
        self.tensor_data.append((info, bytes(raw)))

    def write(self, path: str):
        # assign aligned offsets
        offset = 0
        for info, data in self.tensor_data:
            info.offset = offset
            offset += len(data)
            offset += (self.alignment - offset % self.alignment) % self.alignment

        with open(path, "wb") as f:
            f.write(struct.pack("<I", GGUF_MAGIC))
            f.write(struct.pack("<I", GGUF_VERSION))
            f.write(struct.pack("<q", len(self.tensor_data)))
            f.write(struct.pack("<q", len(self.kv)))
            for key, value, vtype in self.kv:
                _write_string(f, key)
                _write_value(f, value, vtype)
            for info, _ in self.tensor_data:
                _write_string(f, info.name)
                ne = info.ne
                f.write(struct.pack("<I", len(ne)))
                for d in ne:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<i", int(info.ggml_type)))
                f.write(struct.pack("<Q", info.offset))
            pad = (self.alignment - f.tell() % self.alignment) % self.alignment
            f.write(b"\x00" * pad)
            data_start = f.tell()
            for info, data in self.tensor_data:
                f.seek(data_start + info.offset)
                f.write(data)
