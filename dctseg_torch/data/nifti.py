"""Minimal pure-numpy NIfTI-1 reader/writer (the port's copy of the JAX
package's ``dctseg/data/nifti.py``).

The port does not depend on nibabel; this module implements the subset of
NIfTI-1 the pipeline needs: .nii / .nii.gz, the standard scalar dtypes,
scl_slope/scl_inter scaling, and single-file (magic ``n+1``) output.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HDR_SIZE = 348


@dataclass
class NiftiImage:
    data: np.ndarray
    affine: np.ndarray          # 4x4 voxel->world (from srow or pixdim)
    header_bytes: Optional[bytes] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    def get_fdata(self) -> np.ndarray:
        return self.data.astype(np.float64)


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        # compresslevel 1: gzip's default 9 costs ~10x the CPU for a few
        # percent on float volumes; decode speed is unaffected
        return gzip.open(path, mode, compresslevel=1) if "w" in mode \
            else gzip.open(path, mode)
    return open(path, mode)


def load(path: str) -> NiftiImage:
    with _open(path, "rb") as f:
        raw = f.read()
    hdr = raw[:HDR_SIZE]
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    if sizeof_hdr != HDR_SIZE:
        # try big-endian
        if struct.unpack_from(">i", hdr, 0)[0] == HDR_SIZE:
            return _load_endian(raw, ">")
        raise ValueError(f"not a NIfTI-1 file: {path}")
    return _load_endian(raw, "<")


def _load_endian(raw: bytes, e: str) -> NiftiImage:
    hdr = raw[:HDR_SIZE]
    dim = struct.unpack_from(e + "8h", hdr, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    datatype = struct.unpack_from(e + "h", hdr, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(e)
    pixdim = struct.unpack_from(e + "8f", hdr, 76)
    vox_offset = int(struct.unpack_from(e + "f", hdr, 108)[0])
    scl_slope = struct.unpack_from(e + "f", hdr, 112)[0]
    scl_inter = struct.unpack_from(e + "f", hdr, 116)[0]
    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw, dtype=dtype, count=count,
                         offset=vox_offset or 352)
    data = data.reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    # affine from srow_x/y/z when sform_code > 0, else diag(pixdim)
    sform_code = struct.unpack_from(e + "h", hdr, 254)[0]
    affine = np.eye(4, dtype=np.float32)
    if sform_code > 0:
        rows = struct.unpack_from(e + "12f", hdr, 280)
        affine[0, :] = rows[0:4]
        affine[1, :] = rows[4:8]
        affine[2, :] = rows[8:12]
    else:
        for i in range(min(3, len(shape))):
            affine[i, i] = pixdim[i + 1] or 1.0
    return NiftiImage(data=np.asarray(data), affine=affine, header_bytes=hdr)


def save(img_or_data, path: str, affine: Optional[np.ndarray] = None) -> None:
    """Write a single-file NIfTI-1 (.nii or .nii.gz)."""
    if isinstance(img_or_data, NiftiImage):
        data = img_or_data.data
        affine = img_or_data.affine if affine is None else affine
    else:
        data = np.asarray(img_or_data)
    if affine is None:
        affine = np.eye(4, dtype=np.float32)
    data = np.ascontiguousarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[np.dtype(data.dtype)]

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, HDR_SIZE)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)   # bitpix
    pixdim = [1.0] * 8
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)                     # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                       # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)                       # scl_inter
    struct.pack_into("<h", hdr, 252, 1)                         # qform_code
    struct.pack_into("<h", hdr, 254, 1)                         # sform_code
    struct.pack_into("<12f", hdr, 280,
                     *np.asarray(affine, np.float32)[:3].ravel())
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    with _open(path, "wb") as f:
        f.write(payload)
