"""Kaldi nnet3 model import + whole-utterance batched TDNN forward (torch).

The port of fac_via_ppg_tpu/frontend/nnet3.py.  The acoustic model is parsed
once into components holding numpy arrays (`Nnet3.to(device)` moves them to
torch tensors on a device) and a whole utterance, or a batch of them, is
evaluated at once: every Offset() is a clamped row-gather along time, every
Append() a concat, every affine one matmul.

Formats: the nnet3 text format (what `nnet3-copy --binary=false` emits),

    <Nnet3>
    input-node name=input dim=40
    component-node name=l1.affine component=l1.affine \
        input=Append(Offset(input, -1), input, Offset(input, 1))
    ...
    output-node name=output input=softmax objective=linear
    <NumComponents> N
    <ComponentName> l1.affine <NaturalGradientAffineComponent> ... </...>

and Kaldi's binary format (the reference's `final.raw`), which
`load_nnet3` recognises by its "\\0B" header and hands to
`nnet3_binary.read_nnet3_binary`.

Descriptor grammar: node names, Offset, Append, Sum, Scale, Round, Const.
Edge semantics match DecodableNnetSimple: context beyond the utterance is
satisfied by clamping to the first/last frame.  Components run in test
mode (BatchNorm with stored stats, Dropout as its expectation).
"""

from __future__ import annotations

import dataclasses
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


# ==========================================================================
# descriptors
# ==========================================================================

@dataclass(frozen=True)
class Descriptor:
    op: str                       # ref | offset | append | sum | scale | round | const
    name: str = ""                # for ref
    args: Tuple["Descriptor", ...] = ()
    offset: int = 0               # for offset / round (modulus)
    scale: float = 1.0            # for scale / const value
    dim: int = 0                  # for const


def _tokenize_descriptor(s: str) -> List[str]:
    return [t for t in re.findall(r"[A-Za-z0-9_.\-]+|[(),]", s)]


def parse_descriptor(s: str) -> Descriptor:
    tokens = _tokenize_descriptor(s)
    pos = 0

    def parse() -> Descriptor:
        nonlocal pos
        if pos >= len(tokens):
            raise ValueError(
                f"truncated descriptor {s!r}: unexpected end of input"
            )
        tok = tokens[pos]
        pos += 1
        if pos < len(tokens) and tokens[pos] == "(":
            pos += 1  # consume '('
            op = tok.lower()
            if op == "offset":
                inner = parse()
                _expect(",")
                off = int(tokens[pos]); pos += 1
                if tokens[pos] == ",":  # optional x-offset, unused
                    pos += 2
                _expect(")")
                return Descriptor("offset", args=(inner,), offset=off)
            if op == "append":
                args = [parse()]
                while tokens[pos] == ",":
                    pos += 1
                    args.append(parse())
                _expect(")")
                return Descriptor("append", args=tuple(args))
            if op == "sum":
                args = [parse()]
                while tokens[pos] == ",":
                    pos += 1
                    args.append(parse())
                _expect(")")
                return Descriptor("sum", args=tuple(args))
            if op == "scale":
                scale = float(tokens[pos]); pos += 1
                _expect(",")
                inner = parse()
                _expect(")")
                return Descriptor("scale", args=(inner,), scale=scale)
            if op == "round":
                inner = parse()
                _expect(",")
                mod = int(tokens[pos]); pos += 1
                _expect(")")
                return Descriptor("round", args=(inner,), offset=mod)
            if op == "const":
                value = float(tokens[pos]); pos += 1
                _expect(",")
                dim = int(tokens[pos]); pos += 1
                _expect(")")
                return Descriptor("const", scale=value, dim=dim)
            raise ValueError(f"Unsupported descriptor op {tok!r}")
        return Descriptor("ref", name=tok)

    def _expect(t: str):
        nonlocal pos
        if pos >= len(tokens) or tokens[pos] != t:
            raise ValueError(f"Expected {t!r} at {tokens[pos:pos+4]}")
        pos += 1

    try:
        d = parse()
    except IndexError:
        # a mid-operand token lookahead ran off a truncated string
        raise ValueError(
            f"truncated descriptor {s!r}: unexpected end of input"
        ) from None
    if pos != len(tokens):
        raise ValueError(f"Trailing descriptor tokens: {tokens[pos:]}")
    return d


# ==========================================================================
# components
# ==========================================================================

@dataclass
class Component:
    kind: str
    attrs: Dict[str, object] = field(default_factory=dict)

    def param_arrays(self) -> Dict[str, np.ndarray]:
        return {
            k: v for k, v in self.attrs.items() if isinstance(v, np.ndarray)
        }


_AFFINE_KINDS = {
    "NaturalGradientAffineComponent",
    "AffineComponent",
    "FixedAffineComponent",
}


def _t(v, x: torch.Tensor) -> torch.Tensor:
    """A component parameter as a tensor on x's device and dtype."""
    return torch.as_tensor(v, device=x.device).to(x.dtype)


def _vec(v, x: torch.Tensor) -> torch.Tensor:
    return _t(v, x).reshape(-1)


def _numel(v) -> int:
    """Element count of an array or tensor attribute."""
    return v.numel() if isinstance(v, torch.Tensor) else int(np.size(v))


def _ints(v) -> List[int]:
    """An integer attribute (array or tensor) as a list of ints."""
    if isinstance(v, torch.Tensor):
        return [int(i) for i in v.reshape(-1).tolist()]
    return [int(i) for i in np.ravel(np.asarray(v))]


def apply_component(comp: Component, x: torch.Tensor) -> torch.Tensor:
    """Apply one component to (..., T, D) activations."""
    kind = comp.kind
    a = comp.attrs
    if kind in _AFFINE_KINDS:
        out = torch.matmul(x, _t(a["LinearParams"], x).T)
        if "BiasParams" in a and _numel(a["BiasParams"]):
            out = out + _vec(a["BiasParams"], x)
        return out
    if kind == "LinearComponent":
        # Kaldi writes only <Params>; with the text parser the matrix may
        # arrive flat -- the input dim is known here, so reshape lazily.
        w = _t(a["Params"], x)
        if w.ndim == 1:
            w = w.reshape(-1, x.shape[-1])
        return torch.matmul(x, w.T)
    if kind == "RectifiedLinearComponent":
        return torch.clamp(x, min=0.0)
    if kind == "SigmoidComponent":
        return torch.sigmoid(x)
    if kind == "TanhComponent":
        return torch.tanh(x)
    if kind == "SoftmaxComponent":
        return torch.softmax(x, dim=-1)
    if kind == "LogSoftmaxComponent":
        return torch.log_softmax(x, dim=-1)
    if kind == "NoOpComponent":
        return x
    if kind == "DropoutComponent":
        # test mode: output the expectation of the train-time mask.
        p = float(a.get("DropoutProportion", 0.0))
        return x * (1.0 - p)
    if kind == "BatchNormComponent":
        dim = int(a["Dim"])
        block = int(a.get("BlockDim", dim))
        eps = float(a.get("Epsilon", 1e-3))
        rms = float(a.get("TargetRms", 1.0))
        # Kaldi's BatchNormComponent::Write normalizes at write time:
        # <StatsMean>/<StatsVar> are the mean and centered variance, NOT
        # accumulated sums, regardless of <Count>.
        mean = _vec(a["StatsMean"], x)
        scale = rms * torch.rsqrt(_vec(a["StatsVar"], x) + eps)
        if block != dim:
            shape = x.shape
            y = (x.reshape(-1, block) - mean) * scale
            return y.reshape(shape)
        return (x - mean) * scale
    if kind == "NormalizeComponent":
        dim = int(a.get("InputDim", x.shape[-1]))
        rms = float(a.get("TargetRms", 1.0))
        add_log_stddev = str(a.get("AddLogStddev", "F")) in ("T", "true", "True")
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-20)
        out = x * (rms * np.sqrt(dim)) / norm
        if add_log_stddev:
            log_stddev = torch.log(norm / np.sqrt(dim) + 1e-20)
            out = torch.cat([out, log_stddev], dim=-1)
        return out
    if kind == "PnormComponent":
        out_dim = int(a["OutputDim"])
        group = int(a["InputDim"]) // out_dim
        x = x.reshape(*x.shape[:-1], out_dim, group)
        return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-20)
    if kind == "FixedScaleComponent":
        return x * _vec(a["Scales"], x)
    if kind == "FixedBiasComponent":
        return x + _vec(a["Bias"], x)
    if kind == "TdnnComponent":
        # Factorized-TDNN building block (TDNN-F models): internal time
        # offsets + affine.  x[t] -> concat_j x[t + off_j] @ W + b, offsets
        # clamped at utterance edges like every other context access.
        offsets = _ints(a["TimeOffsets"])
        x_cat = torch.cat([_shift_time(x, off) for off in offsets], dim=-1)
        w = _t(a["LinearParams"], x)
        if w.ndim == 1:  # flat from the text parser: (out, in) inferred here
            w = w.reshape(-1, x_cat.shape[-1])
        out = torch.matmul(x_cat, w.T)
        if "BiasParams" in a and _numel(a["BiasParams"]):
            out = out + _vec(a["BiasParams"], x)
        return out
    if kind == "SumGroupComponent":
        # sums fixed-size groups of inputs (used by some softmax stacks)
        sizes = _ints(a["Sizes"])
        parts = torch.split(x, sizes, dim=-1)
        return torch.stack([p.sum(dim=-1) for p in parts], dim=-1)
    if kind == "ScaleAndOffsetComponent":
        return x * _vec(a["Scales"], x) + _vec(a["Offsets"], x)
    if kind == "PermuteComponent":
        perm = torch.tensor(_ints(a["ColumnMap"]), device=x.device)
        return x[..., perm]
    if kind == "ClipGradientComponent":
        return x  # training-time only; identity at inference
    raise ValueError(f"Unsupported component kind {kind!r}")


def _shift_time(x: torch.Tensor, offset: int) -> torch.Tensor:
    """out[..., t, :] = x[..., clamp(t + offset, 0, T-1), :]."""
    T = x.shape[-2]
    idx = torch.clamp(torch.arange(T, device=x.device) + offset, 0, T - 1)
    return x.index_select(-2, idx)


# ==========================================================================
# network graph
# ==========================================================================

@dataclass
class Node:
    kind: str                 # input | component | output | dim-range
    name: str
    dim: int = 0
    component: str = ""
    descriptor: Optional[Descriptor] = None
    dim_offset: int = 0       # for dim-range nodes


@dataclass
class Nnet3:
    """Parsed nnet3 network: graph nodes + component parameters."""

    nodes: Dict[str, Node]
    node_order: List[str]
    components: Dict[str, Component]

    @property
    def input_dim(self) -> int:
        return self.nodes["input"].dim

    def left_context(self) -> int:
        return -min(0, self._total_context()[0])

    def right_context(self) -> int:
        return max(0, self._total_context()[1])

    def _total_context(self) -> Tuple[int, int]:
        lo = hi = 0

        def walk(d: Descriptor, shift: int):
            nonlocal lo, hi
            if d.op == "ref":
                node = self.nodes[d.name]
                if node.kind == "input":
                    lo = min(lo, shift)
                    hi = max(hi, shift)
                elif node.descriptor is not None:
                    walk(node.descriptor, shift)
            elif d.op == "offset":
                walk(d.args[0], shift + d.offset)
            else:
                for a in d.args:
                    walk(a, shift)

        out = self.nodes["output"]
        if out.descriptor is not None:
            walk(out.descriptor, 0)
        return lo, hi

    def to(self, device) -> "Nnet3":
        """A copy whose component arrays are float32 tensors on `device`."""
        def move(v):
            if isinstance(v, np.ndarray):
                return torch.as_tensor(v, dtype=torch.float32, device=device)
            return v

        comps = {
            name: Component(c.kind, {k: move(v) for k, v in c.attrs.items()})
            for name, c in self.components.items()
        }
        return dataclasses.replace(self, components=comps)

    # -------------------------------------------------------------- forward
    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(..., T, input_dim) -> (..., T, output_dim), whole utterances at
        once; leading dimensions are a batch."""
        T = feats.shape[-2]
        cache: Dict[str, torch.Tensor] = {}

        def eval_desc(d: Descriptor) -> torch.Tensor:
            if d.op == "ref":
                return eval_node(d.name)
            if d.op == "offset":
                return _shift_time(eval_desc(d.args[0]), d.offset)
            if d.op == "append":
                return torch.cat([eval_desc(a) for a in d.args], dim=-1)
            if d.op == "sum":
                out = eval_desc(d.args[0])
                for a in d.args[1:]:
                    out = out + eval_desc(a)
                return out
            if d.op == "scale":
                return d.scale * eval_desc(d.args[0])
            if d.op == "round":
                x = eval_desc(d.args[0])
                idx = (torch.arange(T, device=x.device) // d.offset) * d.offset
                return x.index_select(-2, torch.clamp(idx, 0, T - 1))
            if d.op == "const":
                return torch.full((*feats.shape[:-1], d.dim), d.scale,
                                  dtype=feats.dtype, device=feats.device)
            raise ValueError(f"Bad descriptor op {d.op!r}")

        def eval_node(name: str) -> torch.Tensor:
            if name in cache:
                return cache[name]
            node = self.nodes[name]
            if node.kind == "input":
                value = feats
            elif node.kind == "component":
                pre = eval_desc(node.descriptor)
                value = apply_component(self.components[node.component], pre)
            elif node.kind == "output":
                value = eval_desc(node.descriptor)
            elif node.kind == "dim-range":
                base = eval_desc(node.descriptor)
                value = base[..., node.dim_offset : node.dim_offset + node.dim]
            else:
                raise ValueError(f"Bad node kind {node.kind!r}")
            cache[name] = value
            return value

        return eval_node("output")


# ==========================================================================
# text-format parser
# ==========================================================================

_CONFIG_LINE = re.compile(r"^(input-node|component-node|output-node|dim-range-node)\s")


class _TokenStream:
    def __init__(self, text: str):
        self.tokens = text.split()
        self.pos = 0

    def peek(self) -> str:
        return self.tokens[self.pos]

    def next(self) -> str:
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def done(self) -> bool:
        return self.pos >= len(self.tokens)


def parse_nnet3_text(text: str) -> Nnet3:
    """Parse the nnet3 text format."""
    # Split off the config section (graph) from the components section.
    lines = text.splitlines()
    i = 0
    nodes: Dict[str, Node] = {}
    node_order: List[str] = []
    if lines and lines[0].strip().startswith("<Nnet3>"):
        i = 1
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("<NumComponents>"):
            break
        i += 1
        if not line or not _CONFIG_LINE.match(line):
            continue
        kind_tok, rest = line.split(None, 1)
        kv = _parse_config_kv(rest)
        name = kv["name"]
        if kind_tok == "input-node":
            nodes[name] = Node("input", name, dim=int(kv["dim"]))
        elif kind_tok == "component-node":
            nodes[name] = Node(
                "component",
                name,
                component=kv["component"],
                descriptor=parse_descriptor(kv["input"]),
            )
        elif kind_tok == "output-node":
            nodes[name] = Node(
                "output", name, descriptor=parse_descriptor(kv["input"])
            )
        elif kind_tok == "dim-range-node":
            nodes[name] = Node(
                "dim-range",
                name,
                descriptor=parse_descriptor(kv["input-node"]),
                dim=int(kv["dim"]),
                dim_offset=int(kv["dim-offset"]),
            )
        node_order.append(name)

    # ------------------------------------------------------------ components
    comp_text = "\n".join(lines[i:])
    components = _parse_components_text(comp_text)
    return Nnet3(nodes=nodes, node_order=node_order, components=components)


def _parse_config_kv(rest: str) -> Dict[str, str]:
    """Parse 'k1=v1 k2=v2 ...' where values may contain balanced parens."""
    kv = {}
    pos = 0
    n = len(rest)
    while pos < n:
        while pos < n and rest[pos].isspace():
            pos += 1
        if pos >= n:
            break
        eq = rest.find("=", pos)
        if eq < 0:
            break
        key = rest[pos:eq]
        pos = eq + 1
        depth = 0
        start = pos
        while pos < n and (depth > 0 or not rest[pos].isspace()):
            if rest[pos] == "(":
                depth += 1
            elif rest[pos] == ")":
                depth -= 1
            pos += 1
        kv[key] = rest[start:pos]
    return kv


_SCALAR_RE = re.compile(r"^[-+0-9.eE]+$")


def _parse_components_text(text: str) -> Dict[str, Component]:
    ts = _TokenStream(text)
    components: Dict[str, Component] = {}
    # expect: <NumComponents> N
    while not ts.done() and ts.peek() != "<NumComponents>":
        ts.next()
    if ts.done():
        return components
    ts.next()
    num = int(ts.next())
    for _ in range(num):
        tok = ts.next()
        if tok != "<ComponentName>":
            raise ValueError(f"Expected <ComponentName>, got {tok!r}")
        name = ts.next()
        kind_tok = ts.next()
        kind = kind_tok.strip("<>")
        attrs: Dict[str, object] = {}
        end_tok = f"</{kind}>"
        while True:
            tok = ts.next()
            if tok == end_tok:
                break
            if tok.startswith("<") and tok.endswith(">"):
                key = tok.strip("<>")
                if ts.done():
                    break
                if ts.peek() == "[":
                    attrs[key] = _read_bracket_array(ts)
                elif ts.peek().startswith("<"):
                    attrs[key] = True  # flag-style key
                else:
                    attrs[key] = _coerce(ts.next())
            # stray tokens (e.g. nested structures we ignore) are skipped
        components[name] = Component(kind=kind, attrs=attrs)
    return components


def _coerce(tok: str):
    if _SCALAR_RE.match(tok):
        try:
            if re.match(r"^[-+]?\d+$", tok):
                return int(tok)
            return float(tok)
        except ValueError:
            return tok
    return tok


def _read_bracket_array(ts: _TokenStream) -> np.ndarray:
    """Read '[ ... ]' as a flat float array; reshaping into matrix rows uses
    the row count inferred from Kaldi's convention that each matrix row ends
    with a newline — token streams lose newlines, so we detect matrices by
    bracket nesting: Kaldi text matrices are single-bracket with newline rows.
    We instead rebuild rows later from known component dims; as a fallback
    a flat array works for every supported component because only
    LinearParams/Params need a 2-D shape and those components always carry
    explicit dim information via the bias/other vectors."""
    assert ts.next() == "["
    values = []
    rows = []
    while True:
        tok = ts.next()
        if tok == "]":
            break
        if tok == ";":  # some writers separate rows with ';'
            rows.append(len(values))
            continue
        values.append(float(tok))
    return np.asarray(values, dtype=np.float32)


def load_nnet3(path: str) -> Nnet3:
    """Load an nnet3 model file, text or binary format.

    A malformed or corrupt file raises ValueError naming the path, never a
    bare struct.error / IndexError / KeyError from inside the parse."""
    try:
        with open(path, "rb") as f:
            head = f.read(2)
            if head == b"\x00B":
                from fac_via_ppg_torch.frontend.nnet3_binary import (
                    read_nnet3_binary,
                )

                return read_nnet3_binary(f)
            if head.startswith(b"\x00") or not head:
                # a lone \x00 (a truncated binary header) or an empty file
                # is not a text model: do not parse it as one
                raise ValueError(
                    f"{path}: truncated or corrupt nnet3 file "
                    f"(header {head!r})"
                )
        with open(path, "r") as f:
            # a non-UTF-8 byte raises UnicodeDecodeError, a ValueError
            net = parse_nnet3_text(f.read())
        _fix_matrix_shapes(net)
        return net
    except ValueError:
        raise
    except (struct.error, IndexError, KeyError, OverflowError, EOFError,
            StopIteration) as e:
        raise ValueError(
            f"{path}: malformed or corrupt nnet3 file "
            f"({type(e).__name__}: {e})"
        ) from e


def _fix_matrix_shapes(net: Nnet3):
    """Reshape flat LinearParams/Params arrays to (out_dim, in_dim).

    out_dim comes from BiasParams (affine) or must divide the flat size
    consistently with the graph's declared dims.
    """
    for comp in net.components.values():
        if comp.kind in _AFFINE_KINDS and "LinearParams" in comp.attrs:
            flat = np.ravel(comp.attrs["LinearParams"])
            bias = np.ravel(comp.attrs.get("BiasParams", np.zeros(0)))
            if bias.size:
                out_dim = bias.size
            else:
                raise ValueError(
                    f"Affine component without bias: cannot infer shape."
                )
            comp.attrs["LinearParams"] = flat.reshape(out_dim, -1)
        elif comp.kind == "LinearComponent" and "Params" in comp.attrs:
            flat = np.ravel(comp.attrs["Params"])
            out_dim = int(comp.attrs.get("OutputDim", 0))
            if out_dim:
                comp.attrs["Params"] = flat.reshape(out_dim, -1)
            # else: Kaldi never writes <OutputDim>; apply_component reshapes
            # lazily from the input dim at forward time.


# ==========================================================================
# writer + random TDNN generator (fixtures / substitute AM)
# ==========================================================================

def write_nnet3_text(net: Nnet3, path: str):
    """Write a network in nnet3 text format (round-trips with load_nnet3)."""
    with open(path, "w") as f:
        f.write("<Nnet3> \n")
        for name in net.node_order:
            node = net.nodes[name]
            if node.kind == "input":
                f.write(f"input-node name={name} dim={node.dim}\n")
            elif node.kind == "component":
                f.write(
                    f"component-node name={name} component={node.component} "
                    f"input={_descriptor_str(node.descriptor)}\n"
                )
            elif node.kind == "output":
                f.write(
                    f"output-node name={name} "
                    f"input={_descriptor_str(node.descriptor)} objective=linear\n"
                )
            elif node.kind == "dim-range":
                f.write(
                    f"dim-range-node name={name} "
                    f"input-node={_descriptor_str(node.descriptor)} "
                    f"dim={node.dim} dim-offset={node.dim_offset}\n"
                )
        f.write(f"\n<NumComponents> {len(net.components)} \n")
        for name, comp in net.components.items():
            f.write(f"<ComponentName> {name} <{comp.kind}> ")
            for key, val in comp.attrs.items():
                if isinstance(val, np.ndarray):
                    if val.ndim == 2:
                        f.write(f"<{key}>  [\n")
                        for row in val:
                            f.write("  " + " ".join(repr(float(v)) for v in row) + "\n")
                        f.write(" ]\n ")
                    else:
                        f.write(
                            f"<{key}>  [ "
                            + " ".join(repr(float(v)) for v in np.ravel(val))
                            + " ]\n "
                        )
                elif val is True:
                    f.write(f"<{key}> ")
                else:
                    f.write(f"<{key}> {val} ")
            f.write(f"</{comp.kind}>\n")
        f.write("</Nnet3> \n")


def _descriptor_str(d: Descriptor) -> str:
    if d.op == "ref":
        return d.name
    if d.op == "offset":
        return f"Offset({_descriptor_str(d.args[0])}, {d.offset})"
    if d.op == "append":
        return "Append(" + ", ".join(_descriptor_str(a) for a in d.args) + ")"
    if d.op == "sum":
        return "Sum(" + ", ".join(_descriptor_str(a) for a in d.args) + ")"
    if d.op == "scale":
        return f"Scale({d.scale}, {_descriptor_str(d.args[0])})"
    if d.op == "round":
        return f"Round({_descriptor_str(d.args[0])}, {d.offset})"
    if d.op == "const":
        return f"Const({d.scale}, {d.dim})"
    raise ValueError(d.op)


def make_random_tdnn(
    input_dim: int = 40,
    output_dim: int = 5816,
    hidden_dim: int = 256,
    num_layers: int = 3,
    seed: int = 0,
) -> Nnet3:
    """Build a random softmax-output TDNN in nnet3 form.

    Serves as the substitute acoustic model: the reference's `final.raw` is a
    missing large blob (SURVEY.md section 2.2), so tests and the default data
    directory use a structurally-equivalent random TDNN (same input dim,
    same 5816-senone softmax output, Offset/Append context like real AMs).
    """
    rng = np.random.RandomState(seed)
    nodes: Dict[str, Node] = {
        "input": Node("input", "input", dim=input_dim)
    }
    node_order = ["input"]
    components: Dict[str, Component] = {}

    prev = "input"
    prev_dim = input_dim
    for layer in range(num_layers):
        ctx = [-1, 0, 1] if layer % 2 == 0 else [-3, 0, 3]
        in_dim = prev_dim * len(ctx)
        aff = f"tdnn{layer + 1}.affine"
        relu = f"tdnn{layer + 1}.relu"
        bn = f"tdnn{layer + 1}.batchnorm"
        components[aff] = Component(
            "NaturalGradientAffineComponent",
            {
                "LearningRate": 0.001,
                "LinearParams": (
                    rng.randn(hidden_dim, in_dim) / np.sqrt(in_dim)
                ).astype(np.float32),
                "BiasParams": rng.randn(hidden_dim).astype(np.float32) * 0.1,
            },
        )
        components[relu] = Component("RectifiedLinearComponent", {"Dim": hidden_dim})
        mean = rng.randn(hidden_dim).astype(np.float32) * 0.05
        var = (0.5 + rng.rand(hidden_dim)).astype(np.float32)
        components[bn] = Component(
            "BatchNormComponent",
            {
                "Dim": hidden_dim,
                "BlockDim": hidden_dim,
                "Epsilon": 0.001,
                "TargetRms": 1.0,
                "Count": 1.0,
                "StatsMean": mean,
                "StatsVar": var,
            },
        )
        parts = ", ".join(
            (f"Offset({prev}, {o})" if o else prev) for o in ctx
        )
        nodes[aff] = Node(
            "component", aff, component=aff,
            descriptor=parse_descriptor(f"Append({parts})"),
        )
        nodes[relu] = Node(
            "component", relu, component=relu, descriptor=parse_descriptor(aff)
        )
        nodes[bn] = Node(
            "component", bn, component=bn, descriptor=parse_descriptor(relu)
        )
        node_order += [aff, relu, bn]
        prev, prev_dim = bn, hidden_dim

    components["final.affine"] = Component(
        "NaturalGradientAffineComponent",
        {
            "LinearParams": (
                rng.randn(output_dim, prev_dim) / np.sqrt(prev_dim)
            ).astype(np.float32),
            "BiasParams": np.zeros(output_dim, dtype=np.float32),
        },
    )
    components["final.softmax"] = Component("SoftmaxComponent", {"Dim": output_dim})
    nodes["final.affine"] = Node(
        "component", "final.affine", component="final.affine",
        descriptor=parse_descriptor(prev),
    )
    nodes["final.softmax"] = Node(
        "component", "final.softmax", component="final.softmax",
        descriptor=parse_descriptor("final.affine"),
    )
    nodes["output"] = Node(
        "output", "output", descriptor=parse_descriptor("final.softmax")
    )
    node_order += ["final.affine", "final.softmax", "output"]
    return Nnet3(nodes=nodes, node_order=node_order, components=components)
