"""Binary nnet3 model reading and writing (a copy of
fac_via_ppg_tpu/frontend/nnet3_binary.py on the port's own `kaldi_io` and
`nnet3`).

Kaldi's binary `.raw` acoustic models, the reference's `final.raw`
among them, are a hybrid stream: after the "\\0B<Nnet3>" header the graph
section is plain text config lines (the same lines `nnet3.py` parses),
followed by components whose scalar fields are size-prefixed binary basic
types and whose parameters are binary FM/FV-token matrices.

Per Kaldi conventions:
  * tokens: ASCII, space-terminated (WriteToken); newlines appear between
    sections and are skipped like spaces,
  * basic types: one byte sizeof(T) then little-endian payload
    (WriteBasicType); bool is a single 'T'/'F' byte,
  * integer vectors: one byte 4, int32 count, raw int32 payload
    (WriteIntegerVector),
  * matrices/vectors: "FM "/"FV " token + size-prefixed dims + raw data.

Binary basic types are not self-describing between int32 and float32 (both
prefix 0x04), so a per-key type table drives decoding; it covers the full
component set of frontend/nnet3.py.  Unknown keys with unambiguous
encodings (matrices, vectors, bools, doubles) are parsed and kept; an
unknown 0x04-prefixed key is read as int32 (the value is only stored, never
interpreted).  Round-trip with `write_nnet3_binary` is exact.  A malformed
or truncated stream raises `kaldi_io.KaldiIOError` or ValueError
(`load_nnet3` wraps the rest into ValueError naming the file).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict

import numpy as np

from fac_via_ppg_torch.frontend import kaldi_io
from fac_via_ppg_torch.frontend import nnet3 as nnet3_mod
from fac_via_ppg_torch.frontend.nnet3 import (
    Component,
    Nnet3,
    Node,
    parse_descriptor,
)

_WHITESPACE = b" \n\t\r"

# per-key binary decode types for the supported component set
_KEY_TYPES: Dict[str, str] = {
    # int32
    "Dim": "i", "BlockDim": "i", "InputDim": "i", "OutputDim": "i",
    "RankIn": "i", "RankOut": "i", "RankInOut": "i", "UpdatePeriod": "i",
    # float32
    "LearningRate": "f", "LearningRateFactor": "f", "MaxChange": "f",
    "NumSamplesHistory": "f", "Alpha": "f", "Epsilon": "f", "TargetRms": "f",
    "DropoutProportion": "f", "OrthonormalConstraint": "f",
    "SelfRepairScale": "f", "SelfRepairLowerThreshold": "f",
    "SelfRepairUpperThreshold": "f", "MaxChangePerSample": "f",
    # float64
    "Count": "d", "NumDimsSelfRepaired": "d", "NumDimsProcessed": "d",
    # bool ('T'/'F' byte)
    "IsGradient": "b", "TestMode": "b", "UseNaturalGradient": "b",
    "AddLogStddev": "b", "DropoutPerFrame": "b", "IsUpdatable": "b",
    # integer vectors
    "TimeOffsets": "iv", "Sizes": "iv", "ColumnMap": "iv", "Context": "iv",
}


# --------------------------------------------------------------------------
# low-level
# --------------------------------------------------------------------------

def _read_token(f: BinaryIO) -> str:
    chars = []
    while True:
        c = f.read(1)
        if not c:
            if chars:
                break
            raise kaldi_io.KaldiIOError("EOF while reading token")
        if c in _WHITESPACE:
            if chars:
                break
            continue
        chars.append(c)
    return b"".join(chars).decode("ascii")


def _peek(f: BinaryIO, n: int) -> bytes:
    pos = f.tell()
    data = f.read(n)
    f.seek(pos)
    return data


def _skip_ws(f: BinaryIO):
    while True:
        c = _peek(f, 1)
        if c and c in _WHITESPACE:
            f.read(1)
        else:
            return


def _read_basic(f: BinaryIO, kind: str):
    if kind == "b":
        c = f.read(1)
        if c not in (b"T", b"F"):
            raise kaldi_io.KaldiIOError(f"Bad bool byte {c!r}")
        return c == b"T"
    # i/f/d share kaldi_io's validated size-prefixed reader
    return kaldi_io._read_basic(f, kind)


def _read_int_vector(f: BinaryIO) -> np.ndarray:
    prefix = f.read(1)
    if prefix != b"\x04":
        raise kaldi_io.KaldiIOError(f"Bad int-vector prefix {prefix!r}")
    head = f.read(4)
    if len(head) != 4:
        raise kaldi_io.KaldiIOError("Truncated int-vector header")
    (count,) = struct.unpack("<i", head)
    # a corrupt count must not slurp the rest of the file (negative
    # read(-n)) or attempt a multi-GB allocation
    if count < 0 or count > 10**8:
        raise kaldi_io.KaldiIOError(f"Implausible int-vector size {count}")
    data = f.read(4 * count)
    if len(data) != 4 * count:
        raise kaldi_io.KaldiIOError(
            f"Truncated int-vector: wanted {count} ints, got "
            f"{len(data) // 4}"
        )
    return np.frombuffer(data, dtype="<i4").astype(np.int64)


def _read_matrix_or_vector(f: BinaryIO, token: str):
    if token in ("FM", "DM"):
        return kaldi_io.read_matrix_body(f, token)
    if token in ("FV", "DV"):
        return kaldi_io.read_vector_body(f, token)
    raise kaldi_io.KaldiIOError(f"Expected matrix/vector token, got {token!r}")


def _write_token(f: BinaryIO, token: str):
    f.write(token.encode("ascii") + b" ")


def _write_basic(f: BinaryIO, value, kind: str):
    if kind == "b":
        f.write(b"T" if value else b"F")
        return
    kaldi_io._write_basic(f, value, kind)


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

def read_nnet3_binary(f: BinaryIO) -> Nnet3:
    """Parse an open binary nnet3 stream positioned after the \\0B header."""
    token = _read_token(f)
    if token != "<Nnet3>":
        raise kaldi_io.KaldiIOError(f"Expected <Nnet3>, got {token!r}")

    # graph section: text config lines up to a blank line / <NumComponents>
    nodes: Dict[str, Node] = {}
    node_order = []
    while True:
        _skip_ws(f)
        head = _peek(f, len(b"<NumComponents>"))
        if head == b"<NumComponents>":
            break
        if not head:
            raise kaldi_io.KaldiIOError(
                "Truncated nnet3 file: EOF before <NumComponents>."
            )
        line_bytes = []
        while True:
            c = f.read(1)
            if not c or c == b"\n":
                break
            line_bytes.append(c)
        line = b"".join(line_bytes).decode("utf-8").strip()
        if not line:
            continue
        _parse_config_line(line, nodes, node_order)

    tok = _read_token(f)
    if tok != "<NumComponents>":
        raise kaldi_io.KaldiIOError(f"Expected <NumComponents>, got {tok!r}")
    num = _read_basic(f, "i")

    components: Dict[str, Component] = {}
    for _ in range(num):
        tok = _read_token(f)
        if tok != "<ComponentName>":
            raise kaldi_io.KaldiIOError(f"Expected <ComponentName>, got {tok!r}")
        name = _read_token(f)
        kind_tok = _read_token(f)
        kind = kind_tok.strip("<>")
        end_tok = f"</{kind}>"
        attrs: Dict[str, object] = {}
        while True:
            tok = _read_token(f)
            if tok == end_tok:
                break
            if not (tok.startswith("<") and tok.endswith(">")):
                continue  # stray literal (shouldn't happen)
            key = tok.strip("<>")
            _skip_ws(f)
            head = _peek(f, 2)
            if head[:2] in (b"FM", b"DM", b"FV", b"DV"):
                mtok = _read_token(f)
                attrs[key] = _read_matrix_or_vector(f, mtok)
                continue
            kind_code = _KEY_TYPES.get(key)
            if kind_code == "iv":
                attrs[key] = _read_int_vector(f)
            elif kind_code is not None:
                attrs[key] = _read_basic(f, kind_code)
            elif head[:1] in (b"T", b"F"):
                attrs[key] = _read_basic(f, "b")
            elif head[:1] == b"\x08":
                attrs[key] = _read_basic(f, "d")
            elif head[:1] == b"\x04":
                attrs[key] = _read_basic(f, "i")  # stored, never interpreted
            else:
                raise kaldi_io.KaldiIOError(
                    f"Cannot decode binary value for unknown key <{key}> in "
                    f"{kind} (prefix {head!r}); extend _KEY_TYPES."
                )
        # normalize bools to the text parser's 'T'/'F' convention
        for k, v in list(attrs.items()):
            if isinstance(v, bool):
                attrs[k] = "T" if v else "F"
        components[name] = Component(kind=kind, attrs=attrs)

    # closing token: catches files truncated inside the final component's
    # tail, which would otherwise parse "successfully"
    tok = _read_token(f)
    if tok != "</Nnet3>":
        raise kaldi_io.KaldiIOError(f"Expected </Nnet3>, got {tok!r}")

    net = Nnet3(nodes=nodes, node_order=node_order, components=components)
    _reshape_params(net)
    return net


def _parse_config_line(line: str, nodes, node_order):
    if not nnet3_mod._CONFIG_LINE.match(line):
        return
    kind_tok, rest = line.split(None, 1)
    kv = nnet3_mod._parse_config_kv(rest)
    try:
        name = kv["name"]
        _parse_config_fields(kind_tok, kv, nodes, name)
    except KeyError as exc:
        raise ValueError(
            f"truncated or corrupt nnet3 config line {line!r}: "
            f"missing field {exc}"
        ) from None
    node_order.append(name)


def _parse_config_fields(kind_tok, kv, nodes, name):
    if kind_tok == "input-node":
        nodes[name] = Node("input", name, dim=int(kv["dim"]))
    elif kind_tok == "component-node":
        nodes[name] = Node("component", name, component=kv["component"],
                           descriptor=parse_descriptor(kv["input"]))
    elif kind_tok == "output-node":
        nodes[name] = Node("output", name,
                           descriptor=parse_descriptor(kv["input"]))
    elif kind_tok == "dim-range-node":
        nodes[name] = Node("dim-range", name,
                           descriptor=parse_descriptor(kv["input-node"]),
                           dim=int(kv["dim"]),
                           dim_offset=int(kv["dim-offset"]))


def _reshape_params(net: Nnet3):
    """Binary matrices arrive 2-D already; only degenerate 1-row matrices
    stored as vectors would need fixing (none in practice)."""
    for comp in net.components.values():
        if comp.kind in nnet3_mod._AFFINE_KINDS:
            w = comp.attrs.get("LinearParams")
            if isinstance(w, np.ndarray) and w.ndim == 1:
                bias = np.ravel(comp.attrs.get("BiasParams", np.zeros(0)))
                if bias.size:
                    comp.attrs["LinearParams"] = w.reshape(bias.size, -1)


# --------------------------------------------------------------------------
# writer (round-trip validation + exporting models in binary form)
# --------------------------------------------------------------------------

def write_nnet3_binary(net: Nnet3, path: str):
    """Write `net` as a Kaldi binary nnet3 model (`load_nnet3` reads it)."""
    desc = nnet3_mod._descriptor_str
    with open(path, "wb") as f:
        f.write(b"\x00B")
        _write_token(f, "<Nnet3>")
        f.write(b"\n")
        for name in net.node_order:
            node = net.nodes[name]
            if node.kind == "input":
                line = f"input-node name={name} dim={node.dim}"
            elif node.kind == "component":
                line = (f"component-node name={name} "
                        f"component={node.component} "
                        f"input={desc(node.descriptor)}")
            elif node.kind == "output":
                line = (f"output-node name={name} "
                        f"input={desc(node.descriptor)} "
                        f"objective=linear")
            else:
                line = (f"dim-range-node name={name} "
                        f"input-node={desc(node.descriptor)} "
                        f"dim={node.dim} dim-offset={node.dim_offset}")
            f.write(line.encode("utf-8") + b"\n")
        f.write(b"\n")
        _write_token(f, "<NumComponents>")
        _write_basic(f, len(net.components), "i")
        for name, comp in net.components.items():
            _write_token(f, "<ComponentName>")
            _write_token(f, name)
            _write_token(f, f"<{comp.kind}>")
            for key, val in comp.attrs.items():
                _write_token(f, f"<{key}>")
                if isinstance(val, np.ndarray) and val.dtype.kind == "f":
                    if val.ndim == 2:
                        _write_token(f, "FM")
                        _write_basic(f, val.shape[0], "i")
                        _write_basic(f, val.shape[1], "i")
                        f.write(np.ascontiguousarray(val, "<f4").tobytes())
                    else:
                        _write_token(f, "FV")
                        _write_basic(f, val.shape[0], "i")
                        f.write(np.ascontiguousarray(val, "<f4").tobytes())
                elif isinstance(val, np.ndarray):  # integer vector
                    f.write(b"\x04" + struct.pack("<i", val.size))
                    f.write(np.ascontiguousarray(val, "<i4").tobytes())
                elif isinstance(val, str) and val in ("T", "F"):
                    f.write(val.encode("ascii"))
                elif isinstance(val, bool):
                    _write_basic(f, val, "b")
                elif isinstance(val, (int, float)):
                    # the key-type table decides the encoding: a float-typed
                    # key whose value prints integral (e.g. <TargetRms> 1)
                    # must still be float32 bits, or the reader reinterprets
                    # the int32 pattern as a denormal
                    kind = _KEY_TYPES.get(
                        key, "i" if isinstance(val, int) else "f"
                    )
                    if kind in ("f", "d", "i"):
                        _write_basic(f, val, kind)
                    else:
                        raise ValueError(
                            f"Cannot binary-encode {key}={val!r} (type "
                            f"table says {kind!r})"
                        )
                else:
                    raise ValueError(
                        f"Cannot binary-encode {key}={val!r} ({type(val)})"
                    )
            _write_token(f, f"</{comp.kind}>")
            f.write(b"\n")
        _write_token(f, "</Nnet3>")
