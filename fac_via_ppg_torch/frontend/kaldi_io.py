"""Kaldi binary/text I/O (a copy of fac_via_ppg_tpu/frontend/kaldi_io.py).

The reference reaches Kaldi's C++ readers through pykaldi
(`kaldi.util.io.xopen/read_matrix`, reference src/common/feat.py:159-171,
src/common/decode.py:23-38).  This is a from-scratch reader/writer for the
on-disk formats those functions consume:

  binary stream = b"\\0B" + tokens
    "FM " / "DM "  float/double matrix: <i4:rows> <i4:cols> row-major data
    "FV " / "DV "  float/double vector: <i4:dim> data
    "SM "          sparse float matrix: <i4:rows> then per row
    "SV "          sparse float vector: <i4:dim> <i4:nnz> (<i4:idx> <f4:val>)*
  basic types are size-prefixed: one byte sizeof(T) then little-endian bytes.

Text format (" [\n 1 2\n 3 4 ]") is also supported for matrices/vectors.

Verified against the real artifacts shipped with the reference:
`data/feats/final.mat` (40x91 LDA) and `data/feats/reduce_dim.mat`
(40x5816 senone->monophone map, sum == 5816).
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO

import numpy as np

_BINARY_HEADER = b"\x00B"


class KaldiIOError(ValueError):
    pass


# --------------------------------------------------------------------------
# low-level helpers
# --------------------------------------------------------------------------

def _read_token(f: BinaryIO) -> str:
    """Read a whitespace-terminated token."""
    chars = []
    while True:
        c = f.read(1)
        if not c:
            raise KaldiIOError("Unexpected EOF while reading token.")
        if c == b" ":
            if chars:
                break
            continue
        chars.append(c)
    return b"".join(chars).decode("ascii")


def _read_basic(f: BinaryIO, dtype: str):
    """Read a size-prefixed basic type ('i' int32, 'f' float32, 'd' float64)."""
    size = {"i": 4, "f": 4, "d": 8}[dtype]
    prefix = f.read(1)
    if len(prefix) != 1 or prefix[0] != size:
        raise KaldiIOError(
            f"Bad basic-type size prefix {prefix!r}, expected {size}."
        )
    data = f.read(size)
    if len(data) != size:
        raise KaldiIOError("Unexpected EOF in basic type.")
    return struct.unpack("<" + {"i": "i", "f": "f", "d": "d"}[dtype], data)[0]


def _write_token(f: BinaryIO, token: str):
    f.write(token.encode("ascii") + b" ")


def _write_basic(f: BinaryIO, value, dtype: str):
    size, fmt = {"i": (4, "i"), "f": (4, "f"), "d": (8, "d")}[dtype]
    f.write(bytes([size]) + struct.pack("<" + fmt, value))


def _peek_binary(f: BinaryIO) -> bool:
    head = f.read(2)
    if head == _BINARY_HEADER:
        return True
    f.seek(-len(head), io.SEEK_CUR)
    return False


# --------------------------------------------------------------------------
# dense matrix / vector
# --------------------------------------------------------------------------

def _read_text_matrix(f: BinaryIO) -> np.ndarray:
    text = f.read().decode("utf-8")
    start = text.index("[")
    end = text.index("]")
    rows = [
        np.array(r.split(), dtype=np.float64)
        for r in text[start + 1 : end].strip().splitlines()
        if r.strip()
    ]
    if not rows:
        return np.zeros((0, 0), dtype=np.float32)
    return np.vstack(rows).astype(np.float32)


def _checked_count(n: int, what: str, limit: int = 10**8) -> int:
    """Dimension/count fields from untrusted files: a corrupt value must
    not turn into a negative read (io raises a bare ValueError) or an
    attempted multi-GB allocation."""
    if n < 0 or n > limit:
        raise KaldiIOError(f"Implausible {what} {n} in Kaldi stream.")
    return n


def read_matrix_body(f: BinaryIO, token: str) -> np.ndarray:
    """Binary matrix payload following an already-consumed FM/DM token."""
    if token not in ("FM", "DM"):
        raise KaldiIOError(f"Expected matrix token FM/DM, got {token!r}.")
    rows = _checked_count(_read_basic(f, "i"), "matrix rows")
    cols = _checked_count(_read_basic(f, "i"), "matrix cols")
    _checked_count(rows * cols, "matrix size", limit=10**9)
    dt = np.float32 if token == "FM" else np.float64
    raw = f.read(rows * cols * dt().itemsize)
    if len(raw) != rows * cols * dt().itemsize:
        raise KaldiIOError("Matrix data truncated.")
    return np.frombuffer(raw, dtype=dt).reshape(rows, cols).astype(np.float32)


def read_vector_body(f: BinaryIO, token: str) -> np.ndarray:
    """Binary vector payload following an already-consumed FV/DV token."""
    if token not in ("FV", "DV"):
        raise KaldiIOError(f"Expected vector token FV/DV, got {token!r}.")
    dim = _checked_count(_read_basic(f, "i"), "vector dim", limit=10**9)
    dt = np.float32 if token == "FV" else np.float64
    raw = f.read(dim * dt().itemsize)
    if len(raw) != dim * dt().itemsize:
        raise KaldiIOError("Vector data truncated.")
    return np.frombuffer(raw, dtype=dt).astype(np.float32)


def read_matrix_stream(f: BinaryIO) -> np.ndarray:
    if _peek_binary(f):
        return read_matrix_body(f, _read_token(f))
    return _read_text_matrix(f)


def read_matrix(path: str) -> np.ndarray:
    """Read a Kaldi matrix file (binary or text) into (rows, cols) float32."""
    with open(path, "rb") as f:
        return read_matrix_stream(f)


def write_matrix(path: str, mat: np.ndarray):
    """Write a float32 Kaldi binary matrix."""
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    if mat.ndim != 2:
        raise ValueError("write_matrix expects a 2-D array.")
    with open(path, "wb") as f:
        f.write(_BINARY_HEADER)
        _write_token(f, "FM")
        _write_basic(f, mat.shape[0], "i")
        _write_basic(f, mat.shape[1], "i")
        f.write(mat.tobytes())


def read_vector_stream(f: BinaryIO) -> np.ndarray:
    if _peek_binary(f):
        return read_vector_body(f, _read_token(f))
    text = f.read().decode("utf-8")
    body = text[text.index("[") + 1 : text.index("]")]
    return np.array(body.split(), dtype=np.float32)


def read_vector(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return read_vector_stream(f)


def write_vector(path: str, vec: np.ndarray):
    vec = np.ascontiguousarray(vec, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(_BINARY_HEADER)
        _write_token(f, "FV")
        _write_basic(f, vec.shape[0], "i")
        f.write(vec.tobytes())


# --------------------------------------------------------------------------
# sparse matrix
# --------------------------------------------------------------------------

def read_sparse_matrix_stream(f: BinaryIO) -> np.ndarray:
    """Read a Kaldi SparseMatrix<float>, densified to (rows, cols) float32."""
    if not _peek_binary(f):
        raise KaldiIOError("Text sparse matrices are not supported.")
    token = _read_token(f)
    if token != "SM":
        raise KaldiIOError(f"Expected SM token, got {token!r}.")
    num_rows = _read_basic(f, "i")
    rows = []
    dim = 0
    for _ in range(num_rows):
        row_token = _read_token(f)
        if row_token != "SV":
            raise KaldiIOError(f"Expected SV token, got {row_token!r}.")
        dim = _checked_count(_read_basic(f, "i"), "sparse-row dim")
        nnz = _checked_count(_read_basic(f, "i"), "sparse-row nnz")
        row = np.zeros(dim, dtype=np.float32)
        for _ in range(nnz):
            idx = _read_basic(f, "i")
            val = _read_basic(f, "f")
            if not 0 <= idx < dim:
                # a negative index would silently wrap (Python indexing)
                # and corrupt the row instead of failing
                raise KaldiIOError(
                    f"Sparse index {idx} out of range for dim {dim}."
                )
            row[idx] = val
        rows.append(row)
    if not rows:
        return np.zeros((0, 0), dtype=np.float32)
    return np.stack(rows)


def read_sparse_matrix(path: str) -> np.ndarray:
    """Densified sparse matrix read (reference feat.py:159-171 analogue).

    The only sparse matrix on the reference's hot path is the 40x5816
    senone->monophone reduction; densified it is a 0.9 MB constant whose
    application is one small matmul, so sparse algebra buys nothing.
    """
    with open(path, "rb") as f:
        return read_sparse_matrix_stream(f)


def write_sparse_matrix(path: str, mat: np.ndarray):
    mat = np.asarray(mat, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(_BINARY_HEADER)
        _write_token(f, "SM")
        _write_basic(f, mat.shape[0], "i")
        for row in mat:
            _write_token(f, "SV")
            _write_basic(f, mat.shape[1], "i")
            nz = np.nonzero(row)[0]
            _write_basic(f, len(nz), "i")
            for idx in nz:
                _write_basic(f, int(idx), "i")
                _write_basic(f, float(row[idx]), "f")


# --------------------------------------------------------------------------
# symbol tables & config files
# --------------------------------------------------------------------------

def read_sym_table(path: str) -> dict:
    """Kaldi-style 'symbol index' table -> {symbol: index} (the port's own
    copy of fac_via_ppg_tpu/io/utterance.py::read_sym_table, which
    io/utterance.py re-exports): blank lines skipped, a symbol defined
    twice is a ValueError."""
    sym_table = {}
    with open(path) as reader:
        for line in reader:
            if not line.strip():
                continue
            key, val = line.split()
            if key in sym_table:
                raise ValueError(
                    f"symbol table {path} defines {key!r} twice")
            sym_table[key] = int(val)
    return sym_table


def parse_config(path: str) -> dict:
    """Parse '--name=value' per line (reference feat.py:174-188)."""
    with open(path) as f:
        return dict(
            tuple(line.split("=")) for line in f.read().splitlines() if line
        )
