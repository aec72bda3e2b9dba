"""Kaldi decoder-side model parsers: TransitionModel, den-FST, tree (a
copy of fac_via_ppg_tpu/frontend/kaldi_models.py on the port's own
`kaldi_io` and `nnet3_binary`; its writers write byte-identical files).

Gives `frontend/decode.py` real readers for the surfaces the reference
gets from pykaldi (src/common/decode.py:41-66: hmm.TransitionModel.read,
fstext.StdVectorFst.read), parsed into plain structured Python data.
Layouts follow the published Kaldi / OpenFst binary conventions, built on
the same size-prefixed primitives as kaldi_io / nnet3_binary:

  * TransitionModel (kaldi hmm/transition-model.cc): '\\0B' marker,
    <TransitionModel> { <Topology> int-vectors + per-state pdf classes and
    transition lists </Topology> } <Tuples>/<Triples> tuple table
    <LogProbs> FV vector </LogProbs> </TransitionModel>.  Tuples carry
    (phone, hmm_state, forward_pdf, self_loop_pdf); the older Triples
    table omits self_loop_pdf (== forward_pdf).
  * StdVectorFst (openfst fst/fst.cc FstHeader + fst/vector-fst.h):
    int32 magic 2125659606, length-prefixed fsttype/arctype strings,
    version/flags int32, properties uint64, start/numstates/numarcs
    int64, then per state: final weight float32, narcs int64, arcs of
    (ilabel int32, olabel int32, weight float32, nextstate int32).
  * ContextDependency (kaldi tree/build-tree.cc, tree/event-map.cc):
    ContextDependency N P ToPdf <EventMap> EndContextDependency, where
    EventMap nodes are CE (constant), SE (split on key with yes-set),
    TE (table), NULL.

A malformed or truncated file raises `kaldi_io.KaldiIOError` naming it.
"""

from __future__ import annotations

import contextlib
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, List, Optional, Tuple, Union

import numpy as np

from fac_via_ppg_torch.frontend import kaldi_io
from fac_via_ppg_torch.frontend.kaldi_io import KaldiIOError
from fac_via_ppg_torch.frontend.nnet3_binary import (
    _read_int_vector,
    _read_token,
    _skip_ws,
)

_BINARY_MARKER = b"\x00B"


def _expect_token(f: BinaryIO, want: str):
    got = _read_token(f)
    if got != want:
        raise KaldiIOError(f"Expected token {want!r}, got {got!r}")


def _read_i(f):
    return kaldi_io._read_basic(f, "i")


def _read_f(f):
    return kaldi_io._read_basic(f, "f")


def _write_token(f: BinaryIO, token: str):
    f.write(token.encode("ascii") + b" ")


def _write_i(f, v):
    kaldi_io._write_basic(f, int(v), "i")


def _write_f(f, v):
    kaldi_io._write_basic(f, float(v), "f")


def _write_int_vector(f: BinaryIO, values):
    f.write(b"\x04" + struct.pack("<i", len(values)))
    f.write(np.asarray(values, dtype="<i4").tobytes())


@contextlib.contextmanager
def _corrupt_guard(path: str):
    """Public readers of untrusted model files must fail with KaldiIOError
    naming the file — never a bare struct.error / IndexError / reshape
    ValueError from deep inside the parse."""
    try:
        yield
    except KaldiIOError:
        raise
    except (struct.error, ValueError, IndexError, OverflowError,
            EOFError) as e:
        raise KaldiIOError(
            f"{path}: malformed or corrupt model file "
            f"({type(e).__name__}: {e})"
        ) from e


def _open_binary(path: str) -> BinaryIO:
    f = open(path, "rb")
    if f.read(2) != _BINARY_MARKER:
        f.close()
        raise KaldiIOError(
            f"{path} is not in Kaldi binary format (missing \\0B marker); "
            "text-format models are not supported here"
        )
    return f


# ==========================================================================
# TransitionModel
# ==========================================================================

@dataclass
class HmmState:
    forward_pdf_class: int
    self_loop_pdf_class: int
    # (destination topology state, initial probability)
    transitions: List[Tuple[int, float]] = field(default_factory=list)


@dataclass
class HmmTopology:
    phones: np.ndarray          # sorted phone ids
    phone2idx: np.ndarray       # phone id -> entry index (-1 = absent)
    entries: List[List[HmmState]] = field(default_factory=list)


@dataclass
class TransitionTuple:
    phone: int
    hmm_state: int
    forward_pdf: int
    self_loop_pdf: int


@dataclass
class TransitionModel:
    topology: HmmTopology
    tuples: List[TransitionTuple]
    log_probs: np.ndarray       # (num_transition_ids + 1,) incl. epsilon 0

    @property
    def num_pdfs(self) -> int:
        if not self.tuples:
            return 0
        return 1 + max(
            max(t.forward_pdf, t.self_loop_pdf) for t in self.tuples
        )


def _read_topology(f: BinaryIO) -> HmmTopology:
    _expect_token(f, "<Topology>")
    phones = _read_int_vector(f)
    phone2idx = _read_int_vector(f)
    entries = []
    for _ in range(_read_i(f)):
        states = []
        for _ in range(_read_i(f)):
            fwd = _read_i(f)
            self_loop = _read_i(f)
            trans = [(_read_i(f), _read_f(f)) for _ in range(_read_i(f))]
            states.append(HmmState(fwd, self_loop, trans))
        entries.append(states)
    _expect_token(f, "</Topology>")
    return HmmTopology(phones, phone2idx, entries)


def _write_topology(f: BinaryIO, topo: HmmTopology):
    _write_token(f, "<Topology>")
    _write_int_vector(f, topo.phones)
    _write_int_vector(f, topo.phone2idx)
    _write_i(f, len(topo.entries))
    for entry in topo.entries:
        _write_i(f, len(entry))
        for st in entry:
            _write_i(f, st.forward_pdf_class)
            _write_i(f, st.self_loop_pdf_class)
            _write_i(f, len(st.transitions))
            for dst, prob in st.transitions:
                _write_i(f, dst)
                _write_f(f, prob)
    _write_token(f, "</Topology>")


def read_transition_model_stream(f: BinaryIO) -> TransitionModel:
    _expect_token(f, "<TransitionModel>")
    topo = _read_topology(f)
    table = _read_token(f)
    if table not in ("<Tuples>", "<Triples>"):
        raise KaldiIOError(f"Expected <Tuples>/<Triples>, got {table!r}")
    wide = table == "<Tuples>"
    tuples = []
    for _ in range(_read_i(f)):
        phone, hmm_state, fwd = _read_i(f), _read_i(f), _read_i(f)
        self_loop = _read_i(f) if wide else fwd
        tuples.append(TransitionTuple(phone, hmm_state, fwd, self_loop))
    _expect_token(f, "</Tuples>" if wide else "</Triples>")
    _expect_token(f, "<LogProbs>")
    _skip_ws(f)
    log_probs = kaldi_io.read_vector_body(f, _read_token(f))
    _expect_token(f, "</LogProbs>")
    _expect_token(f, "</TransitionModel>")
    return TransitionModel(topo, tuples, log_probs)


def read_transition_model(path: str) -> TransitionModel:
    """Read the TransitionModel from the head of a binary .mdl file."""
    with _corrupt_guard(path), _open_binary(path) as f:
        return read_transition_model_stream(f)


def write_transition_model(path: str, model: TransitionModel):
    """Write a binary .mdl-header TransitionModel (roundtrip twin)."""
    with open(path, "wb") as f:
        f.write(_BINARY_MARKER)
        _write_token(f, "<TransitionModel>")
        _write_topology(f, model.topology)
        wide = any(t.forward_pdf != t.self_loop_pdf for t in model.tuples)
        _write_token(f, "<Tuples>" if wide else "<Triples>")
        _write_i(f, len(model.tuples))
        for t in model.tuples:
            _write_i(f, t.phone)
            _write_i(f, t.hmm_state)
            _write_i(f, t.forward_pdf)
            if wide:
                _write_i(f, t.self_loop_pdf)
        _write_token(f, "</Tuples>" if wide else "</Triples>")
        _write_token(f, "<LogProbs>")
        _write_token(f, "FV")
        _write_i(f, len(model.log_probs))
        f.write(np.asarray(model.log_probs, dtype="<f4").tobytes())
        _write_token(f, "</LogProbs>")
        _write_token(f, "</TransitionModel>")


# ==========================================================================
# OpenFst StdVectorFst
# ==========================================================================

FST_MAGIC = 2125659606


@dataclass
class StdArc:
    ilabel: int
    olabel: int
    weight: float
    nextstate: int


@dataclass
class FstState:
    final: float                # tropical weight; +inf = non-final
    arcs: List[StdArc] = field(default_factory=list)


@dataclass
class VectorFst:
    start: int
    states: List[FstState] = field(default_factory=list)

    @property
    def num_arcs(self) -> int:
        return sum(len(s.arcs) for s in self.states)


def _read_exact(f: BinaryIO, n: int, what: str) -> bytes:
    """Exact-length read from an untrusted stream: corrupt counts must not
    become negative reads (bare ValueError from io) and truncation must
    surface as KaldiIOError, not struct.error downstream."""
    if n < 0:
        raise KaldiIOError(f"Negative {what} length {n} in FST stream")
    data = f.read(n)
    if len(data) != n:
        raise KaldiIOError(
            f"Truncated FST stream: wanted {n} bytes of {what}, "
            f"got {len(data)}"
        )
    return data


def _read_fst_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<i", _read_exact(f, 4, "string header"))
    if n > 10**4:
        raise KaldiIOError(f"Implausible FST string length {n}")
    try:
        return _read_exact(f, n, "string").decode("ascii")
    except UnicodeDecodeError as e:
        raise KaldiIOError(f"Non-ASCII FST type string: {e}") from e


def _write_fst_string(f: BinaryIO, s: str):
    f.write(struct.pack("<i", len(s)) + s.encode("ascii"))


def read_fst(path: str) -> VectorFst:
    """Read a binary StdVectorFst (the reference's den.fst surface)."""
    with _corrupt_guard(path), open(path, "rb") as f:
        (magic,) = struct.unpack("<i", _read_exact(f, 4, "magic"))
        if magic != FST_MAGIC:
            raise KaldiIOError(
                f"{path}: bad OpenFst magic {magic} (want {FST_MAGIC})"
            )
        fsttype = _read_fst_string(f)
        arctype = _read_fst_string(f)
        if fsttype != "vector" or arctype != "standard":
            raise KaldiIOError(
                f"only StdVectorFst is supported, got {fsttype}/{arctype}"
            )
        _version, flags = struct.unpack("<ii", _read_exact(f, 8, "header"))
        if flags & 0x3:
            # bit 0/1 = attached input/output SymbolTables, serialized
            # between the header and the states — not state data.
            raise KaldiIOError(
                f"{path}: FSTs with embedded symbol tables are not "
                "supported; strip them with fstcompile/fstsymbols first"
            )
        _properties, start, numstates, _numarcs = struct.unpack(
            "<Qqqq", _read_exact(f, 32, "counts")
        )
        if not 0 <= numstates <= 10**8:
            raise KaldiIOError(f"Implausible FST state count {numstates}")
        states = []
        for _ in range(numstates):
            (final,) = struct.unpack("<f", _read_exact(f, 4, "final weight"))
            (narcs,) = struct.unpack("<q", _read_exact(f, 8, "arc count"))
            if not 0 <= narcs <= 10**8:
                raise KaldiIOError(f"Implausible FST arc count {narcs}")
            raw = np.frombuffer(
                _read_exact(f, 16 * narcs, "arcs"), dtype="<u1"
            )
            view = raw.reshape(narcs, 16) if narcs else raw.reshape(0, 16)
            ilabels = view[:, 0:4].copy().view("<i4").ravel()
            olabels = view[:, 4:8].copy().view("<i4").ravel()
            weights = view[:, 8:12].copy().view("<f4").ravel()
            nexts = view[:, 12:16].copy().view("<i4").ravel()
            arcs = [
                StdArc(int(i), int(o), float(w), int(n))
                for i, o, w, n in zip(ilabels, olabels, weights, nexts)
            ]
            states.append(FstState(float(final), arcs))
        return VectorFst(int(start), states)


def write_fst(path: str, fst: VectorFst):
    """Write a binary StdVectorFst (roundtrip twin of read_fst)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", FST_MAGIC))
        _write_fst_string(f, "vector")
        _write_fst_string(f, "standard")
        f.write(struct.pack("<ii", 2, 0))  # version, flags
        f.write(struct.pack(
            "<Qqqq", 1, fst.start, len(fst.states), fst.num_arcs
        ))
        for st in fst.states:
            f.write(struct.pack("<f", st.final))
            f.write(struct.pack("<q", len(st.arcs)))
            for a in st.arcs:
                f.write(struct.pack(
                    "<iifi", a.ilabel, a.olabel, a.weight, a.nextstate
                ))


# ==========================================================================
# ContextDependency (decision tree)
# ==========================================================================

@dataclass
class ConstantEventMap:
    answer: int


@dataclass
class SplitEventMap:
    key: int
    yes_set: np.ndarray
    yes: "EventMapNode"
    no: "EventMapNode"


@dataclass
class TableEventMap:
    key: int
    table: List[Optional["EventMapNode"]]


EventMapNode = Union[ConstantEventMap, SplitEventMap, TableEventMap, None]


@dataclass
class ContextDependency:
    context_width: int          # N
    central_position: int       # P
    to_pdf: EventMapNode

    @property
    def num_pdfs(self) -> int:
        best = -1
        stack = [self.to_pdf]
        while stack:
            node = stack.pop()
            if isinstance(node, ConstantEventMap):
                best = max(best, node.answer)
            elif isinstance(node, SplitEventMap):
                stack += [node.yes, node.no]
            elif isinstance(node, TableEventMap):
                stack += [c for c in node.table if c is not None]
        return best + 1


def _read_event_map(f: BinaryIO) -> EventMapNode:
    """Iterative EventMap parse (real trees nest thousands deep, so no
    recursion).  Stack frames: (kind, node, children, n_needed)."""
    root: List[EventMapNode] = []
    stack = [("root", None, root, 1)]
    while True:
        token = _read_token(f)
        push = None
        if token == "NULL":
            child = None
        elif token == "CE":
            child = ConstantEventMap(_read_i(f))
        elif token == "SE":
            key = _read_i(f)
            yes_set = _read_int_vector(f)
            _expect_token(f, "{")
            child = SplitEventMap(key, yes_set, None, None)
            push = ("se", child, [], 2)
        elif token == "TE":
            key = _read_i(f)
            size = _read_i(f)
            _expect_token(f, "(")
            child = TableEventMap(key, [])
            push = ("te", child, child.table, size)
        else:
            raise KaldiIOError(f"Unknown EventMap token {token!r}")
        stack[-1][2].append(child)
        if push is not None:
            stack.append(push)
        while len(stack[-1][2]) == stack[-1][3]:
            kind, node, children, _ = stack.pop()
            if kind == "root":
                return children[0]
            if kind == "se":
                _expect_token(f, "}")
                node.yes, node.no = children
            else:
                _expect_token(f, ")")


def read_context_dependency(path: str) -> ContextDependency:
    """Read a Kaldi decision tree (the `tree` file next to final.mdl)."""
    with _corrupt_guard(path), _open_binary(path) as f:
        _expect_token(f, "ContextDependency")
        n = _read_i(f)
        p = _read_i(f)
        _expect_token(f, "ToPdf")
        to_pdf = _read_event_map(f)
        _expect_token(f, "EndContextDependency")
        return ContextDependency(n, p, to_pdf)


def _write_event_map(f: BinaryIO, node: EventMapNode):
    """Iterative EventMap writer (roundtrip twin of _read_event_map; real
    trees nest thousands deep, so no recursion).  The work stack holds
    either a node to emit or a closing token to write."""
    stack: List = [node]
    while stack:
        item = stack.pop()
        if isinstance(item, str):  # deferred closing token
            _write_token(f, item)
            continue
        if item is None:
            _write_token(f, "NULL")
        elif isinstance(item, ConstantEventMap):
            _write_token(f, "CE")
            _write_i(f, item.answer)
        elif isinstance(item, SplitEventMap):
            _write_token(f, "SE")
            _write_i(f, item.key)
            _write_int_vector(f, item.yes_set)
            _write_token(f, "{")
            stack += ["}", item.no, item.yes]
        elif isinstance(item, TableEventMap):
            _write_token(f, "TE")
            _write_i(f, item.key)
            _write_i(f, len(item.table))
            _write_token(f, "(")
            stack.append(")")
            stack += list(reversed(item.table))
        else:
            raise KaldiIOError(f"Unknown EventMap node {type(item)!r}")


def write_context_dependency(path: str, tree: ContextDependency):
    """Write a binary Kaldi decision tree (roundtrip twin of
    read_context_dependency)."""
    with open(path, "wb") as f:
        f.write(_BINARY_MARKER)
        _write_token(f, "ContextDependency")
        _write_i(f, tree.context_width)
        _write_i(f, tree.central_position)
        _write_token(f, "ToPdf")
        _write_event_map(f, tree.to_pdf)
        _write_token(f, "EndContextDependency")
