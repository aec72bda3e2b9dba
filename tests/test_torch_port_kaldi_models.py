"""The port's Kaldi model readers and writers (frontend/kaldi_models.py,
frontend/decode.py, kaldi_io.read_sym_table) against the JAX package on
the CPU: the JAX writers' files read by the port into equal structures,
the port's writers writing the same bytes, truncated files raising the
same error types, and read_nnet3_model's AM giving the JAX forward (atol
1e-5 in f32, as test_torch_port_frontend.py holds the nnet3 forward).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fac_via_ppg_torch.frontend import decode as t_dec
from fac_via_ppg_torch.frontend import kaldi_io as t_io
from fac_via_ppg_torch.frontend import kaldi_models as t_km
from fac_via_ppg_tpu.frontend import decode as j_dec
from fac_via_ppg_tpu.frontend import kaldi_io as j_io
from fac_via_ppg_tpu.frontend import kaldi_models as j_km
from fac_via_ppg_tpu.frontend import nnet3 as j_nnet3
from fac_via_ppg_tpu.scripts.make_substitute_am import make_bundle


def _as_plain(x, dtypes=True):
    """A structure of either package's dataclasses as plain Python, to
    compare across packages (array dtypes kept where `dtypes`)."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                {f.name: _as_plain(getattr(x, f.name), dtypes)
                 for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [_as_plain(v, dtypes) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist()) if dtypes else x.tolist()
    return x


def _transition_model(km, wide):
    states = [km.HmmState(0, 0 if not wide else 1, [(0, 0.5), (1, 0.5)]),
              km.HmmState(1, 1, [(1, 0.25), (2, 0.75)]),
              km.HmmState(-1, -1, [])]
    topo = km.HmmTopology(phones=np.array([1, 2, 3], np.int32),
                          phone2idx=np.array([-1, 0, 0, 0], np.int32),
                          entries=[states, states[:1] + states[2:]])
    tuples = [km.TransitionTuple(p, s, 2 * p + s, 2 * p + s + int(wide))
              for p in (1, 2, 3) for s in (0, 1)]
    log_probs = np.log(np.linspace(0.05, 1.0, 13)).astype(np.float32)
    return km.TransitionModel(topo, tuples, log_probs)


def _fst(km):
    inf = float("inf")
    return km.VectorFst(start=1, states=[
        km.FstState(inf, [km.StdArc(1, 1, 0.5, 1), km.StdArc(2, 3, 1.25, 2)]),
        km.FstState(inf, [km.StdArc(3, 3, 0.0, 2), km.StdArc(0, 0, 2.5, 0)]),
        km.FstState(0.75, []),
    ])


def _tree(km):
    leaf = km.ConstantEventMap
    table = km.TableEventMap(0, [None, leaf(3), km.SplitEventMap(
        2, np.array([1, 4, 9], np.int32), leaf(5), leaf(6))])
    root = km.SplitEventMap(1, np.array([2, 3], np.int32), table,
                            km.SplitEventMap(0, np.array([7], np.int32),
                                             leaf(0), None))
    return km.ContextDependency(3, 1, root)


MODELS = {
    "triples": (lambda km: _transition_model(km, False),
                "write_transition_model", "read_transition_model"),
    "tuples": (lambda km: _transition_model(km, True),
               "write_transition_model", "read_transition_model"),
    "fst": (_fst, "write_fst", "read_fst"),
    "tree": (_tree, "write_context_dependency", "read_context_dependency"),
}


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_jax_written_models_read_by_the_port(tmp_path, kind):
    make, write, read = MODELS[kind]
    path = str(tmp_path / kind)
    getattr(j_km, write)(path, make(j_km))
    got = getattr(t_km, read)(path)
    want = getattr(j_km, read)(path)
    assert _as_plain(got) == _as_plain(want)
    assert _as_plain(got, False) == _as_plain(make(t_km), False)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_port_writers_write_the_jax_bytes(tmp_path, kind):
    make, write, _ = MODELS[kind]
    getattr(t_km, write)(str(tmp_path / "t"), make(t_km))
    getattr(j_km, write)(str(tmp_path / "j"), make(j_km))
    got = (tmp_path / "t").read_bytes()
    assert got == (tmp_path / "j").read_bytes() and len(got) > 20


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_truncated_and_corrupt_files_raise_as_jax(tmp_path, kind):
    """Every truncation of the file, and a few corrupted bytes, raise the
    same error type in both packages (KaldiIOError, a ValueError naming
    the file), never a bare struct.error."""
    make, write, read = MODELS[kind]
    full = str(tmp_path / "full")
    getattr(j_km, write)(full, make(j_km))
    data = open(full, "rb").read()
    rng = np.random.RandomState(len(data))
    cases = [data[:n] for n in range(0, len(data), 3)]
    for pos in rng.randint(2, len(data), size=6):
        bad = bytearray(data)
        bad[pos] ^= 0xA5
        cases.append(bytes(bad))
    raised = 0
    for i, blob in enumerate(cases):
        path = tmp_path / f"case{i}"
        path.write_bytes(blob)
        outcome = []
        for km in (t_km, j_km):
            try:
                _as_plain(getattr(km, read)(str(path)))
                outcome.append(None)
            except Exception as e:  # noqa: BLE001 - the type is the check
                outcome.append(type(e).__name__)
        assert outcome[0] == outcome[1], (i, outcome)
        if outcome[0] is not None:
            assert outcome[0] == "KaldiIOError", (i, outcome)
            raised += 1
    assert raised >= len(data) // 3


def test_decode_readers(tmp_path):
    j_km.write_transition_model(str(tmp_path / "final.mdl"),
                                _transition_model(j_km, False))
    j_km.write_fst(str(tmp_path / "den.fst"), _fst(j_km))
    tm = t_dec.read_trans_model(str(tmp_path / "final.mdl"))
    assert isinstance(tm, t_dec.TransitionModel) and tm.num_pdfs == 8
    fst = t_dec.read_den_fst(str(tmp_path / "den.fst"))
    assert isinstance(fst, t_dec.VectorFst) and fst.num_arcs == 4
    assert _as_plain(fst) == _as_plain(
        j_dec.read_den_fst(str(tmp_path / "den.fst")))
    j_km.write_context_dependency(str(tmp_path / "tree"), _tree(j_km))
    cd = t_dec.read_context_dependency(str(tmp_path / "tree"))
    assert cd.num_pdfs == 7 and cd.context_width == 3
    (tmp_path / "text.mdl").write_text("<TransitionModel> ...")
    with pytest.raises(ValueError, match="binary"):
        t_dec.read_trans_model(str(tmp_path / "text.mdl"))


def test_read_nnet3_model_gives_jax_forward(tmp_path):
    make_bundle(str(tmp_path), n_senones=24, n_phones=6, hidden_dim=8,
                num_layers=1)
    path = str(tmp_path / "am" / "final.raw.txt")
    t_net = t_dec.read_nnet3_model(path)
    j_net = j_dec.read_nnet3_model(path)
    feats = np.random.RandomState(1).randn(37, t_net.input_dim).astype(
        np.float32)
    with torch.no_grad():
        got = t_net.to("cpu").forward(torch.as_tensor(feats)).numpy()
    want = np.asarray(j_nnet3.jit_forward(j_net, jnp.asarray(feats)))
    assert got.shape == want.shape == (37, 24)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_read_sym_table_matches_jax(tmp_path):
    path = tmp_path / "phones.txt"
    path.write_text("<eps> 0\nSIL 1\n\nAA_B 2\n  \nZH_E 41\n")
    got = t_io.read_sym_table(str(path))
    assert got == j_io.read_sym_table(str(path))
    assert got == {"<eps>": 0, "SIL": 1, "AA_B": 2, "ZH_E": 41}
    dup = tmp_path / "dup.txt"
    dup.write_text("SIL 1\nAA 2\nSIL 3\n")
    for io_mod in (t_io, j_io):
        with pytest.raises(ValueError, match="defines 'SIL' twice"):
            io_mod.read_sym_table(str(dup))
