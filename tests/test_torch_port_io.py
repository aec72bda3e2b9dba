"""The port's io/ (fac_via_ppg_torch/io) on every case of tests/test_io.py
(the JAX package's io/ tests, which mirror the reference's
test_utterance.py / test_align.py): matrix-message roundtrips,
Segment/IntervalTier roundtrips, property surface, time->frame conversion
with short-segment repair, phone normalization (incl. L2-ARCTIC
annotations), symbol tables, TextGrid serialization and full utterance
file roundtrips.  The case that reads the reference's Praat fixture from
its mount reads a TextGrid written in the test instead.  Each case names
the port's function; where the two packages write bytes or text, the
JAX package's is held equal to the port's (exact: the same Python)."""

import numpy as np
import pytest

from fac_via_ppg_torch.io import (
    Interval,
    IntervalTier,
    PointTier,
    TextGrid,
    Utterance,
    get_hardcoded_sym_table,
    is_sil,
    mat_to_numpy,
    normalize_phone,
    normalize_tier_mark,
    numpy_to_mat,
    read_segment,
    read_sym_table,
    read_tg_from_str,
    time_to_frame,
    time_to_frame_interval_tier,
    write_segment,
    write_tg_to_str,
)
from fac_via_ppg_torch.io.proto.data_utterance_pb2 import FloatMatrix, Segment
from fac_via_ppg_tpu import io as j_io

# a Praat long-format TextGrid of the reference fixture's layout: two
# interval tiers (phones, words) with an empty gap mark
PRAAT_TG = """File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 1.25
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 1.25
        intervals: size = 3
        intervals [1]:
            xmin = 0
            xmax = 0.2
            text = ""
        intervals [2]:
            xmin = 0.2
            xmax = 0.95
            text = "HELLO"
        intervals [3]:
            xmin = 0.95
            xmax = 1.25
            text = ""
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 1.25
        intervals: size = 5
        intervals [1]:
            xmin = 0
            xmax = 0.2
            text = "sil"
        intervals [2]:
            xmin = 0.2
            xmax = 0.41
            text = "HH"
        intervals [3]:
            xmin = 0.41
            xmax = 0.6
            text = "AH0"
        intervals [4]:
            xmin = 0.6
            xmax = 0.95
            text = "L OW1"
        intervals [5]:
            xmin = 0.95
            xmax = 1.25
            text = "sp"
"""


# ----------------------------------------------------------- matrix messages

def test_matrix_roundtrip_2d(rng):
    mat = FloatMatrix()
    x = rng.randn(4, 7).astype(np.float32)
    numpy_to_mat(x, mat)
    back = mat_to_numpy(mat)
    np.testing.assert_allclose(back, x, rtol=1e-6)


def test_matrix_roundtrip_row_vector(rng):
    """Row vectors come back 1-D (reference utterance.py:57-62)."""
    mat = FloatMatrix()
    x = rng.randn(9).astype(np.float32)
    numpy_to_mat(x, mat)
    back = mat_to_numpy(mat)
    assert back.shape == (9,)
    np.testing.assert_allclose(back, x, rtol=1e-6)


def test_matrix_roundtrip_empty():
    mat = FloatMatrix()
    numpy_to_mat(np.array([]), mat)
    assert mat.num_row == 0 and mat.num_col == 0
    assert mat_to_numpy(mat).size == 0


def test_single_element_matrix(rng):
    mat = FloatMatrix()
    numpy_to_mat(np.array([2.5]), mat)
    back = mat_to_numpy(mat)
    assert back.shape == (1,)


# ------------------------------------------------------------------ segments

def test_segment_roundtrip():
    tier = IntervalTier("phones", 0.0, 1.0)
    tier.add(0.0, 0.4, "aa")
    tier.add(0.4, 1.0, "b")
    seg = Segment()
    write_segment(tier, seg)
    back = read_segment(seg)
    assert len(back) == 2
    assert back[0].mark == "aa" and back[1].mark == "b"
    assert back[0].minTime == 0.0
    assert abs(back[1].maxTime - 1.0) < 1e-6


def test_segment_inconsistent_raises():
    seg = Segment()
    seg.symbol.append("aa")
    numpy_to_mat(np.array([0.0, 0.5]), seg.start_time)
    numpy_to_mat(np.array([0.5, 1.0]), seg.end_time)
    seg.num_item = 2
    with pytest.raises(ValueError):
        read_segment(seg)


# ---------------------------------------------------------------- time/frame

def test_time_to_frame():
    assert time_to_frame(0.0, 5) == 0
    assert time_to_frame(0.004999, 5) == 0
    assert time_to_frame(0.005, 5) == 1
    assert time_to_frame(1.0, 10) == 100
    with pytest.raises(ValueError):
        time_to_frame(-0.1, 5)


def test_time_to_frame_interval_tier():
    tier = IntervalTier("phones", 0.0, 0.1)
    tier.add(0.0, 0.03, "aa")
    tier.add(0.03, 0.1, "b")
    frames = time_to_frame_interval_tier(tier, 10)
    assert frames[0].minTime == 0 and frames[0].maxTime == 3
    assert frames[1].minTime == 3 and frames[1].maxTime == 10


def test_time_to_frame_short_segment_repair():
    """A sub-frame segment is extended and the next one shifted
    (reference utterance.py:175-196)."""
    tier = IntervalTier("phones", 0.0, 0.1)
    tier.add(0.0, 0.002, "aa")   # < one 10 ms frame
    tier.add(0.002, 0.1, "b")
    frames = time_to_frame_interval_tier(tier, 10)
    assert frames[0].minTime == 0 and frames[0].maxTime == 1
    assert frames[1].minTime == 1 and frames[1].maxTime == 10


# -------------------------------------------------------------- phone labels

def test_is_sil():
    for s in ["sil", "SIL", "sp", "spn", ""]:
        assert is_sil(s)
    assert not is_sil("aa")


def test_normalize_phone():
    assert normalize_phone("AA1") == "aa"
    assert normalize_phone("sp") == "sil"
    # L2-ARCTIC annotation "produced,canonical,error-tag"
    assert normalize_phone("IY0,IH,s") == "iy"
    assert normalize_phone("IY0,IH,s", is_rm_annotation=False) == "iy,ih,s"
    # all-symbol input strips to empty -> silence (matches the reference,
    # whose ValueError branch is unreachable behind the is_sil("") check)
    assert normalize_phone("123") == "sil"


def test_normalize_tier_mark():
    tier = IntervalTier("phones", 0.0, 1.0)
    tier.add(0.0, 0.5, "AA1")
    tier.add(0.5, 1.0, "SP")
    out = normalize_tier_mark(tier)
    assert out[0].mark == "aa" and out[1].mark == "sil"
    with pytest.raises(ValueError):
        normalize_tier_mark(tier, "BadMode")


# ------------------------------------------------------------- symbol tables

def test_hardcoded_sym_table():
    table = get_hardcoded_sym_table()
    assert len(table) == 40
    assert table["aa"] == 0 and table["sil"] == 39


def test_read_sym_table(tmp_path):
    p = tmp_path / "syms.txt"
    p.write_text("aa\t0\nbb\t1\n")
    assert read_sym_table(str(p)) == {"aa": 0, "bb": 1}
    p2 = tmp_path / "dup.txt"
    p2.write_text("aa\t0\naa\t1\n")
    with pytest.raises(ValueError):
        read_sym_table(str(p2))


# ------------------------------------------------------------------ TextGrid

def test_reference_textgrid_roundtrip():
    """Parse a Praat long-format TextGrid and round-trip it; the JAX
    package writes the same text."""
    text = PRAAT_TG
    tg = read_tg_from_str(text)
    assert len(tg) >= 1
    names = tg.getNames()
    out = write_tg_to_str(tg)
    assert out == j_io.write_tg_to_str(j_io.read_tg_from_str(text))
    tg2 = read_tg_from_str(out)
    assert tg2.getNames() == names == ["words", "phones"]
    for t1, t2 in zip(tg.tiers, tg2.tiers):
        if isinstance(t1, IntervalTier):
            assert len(t1) == len(t2)
            for a, b in zip(t1, t2):
                assert a.mark == b.mark
                assert abs(a.minTime - b.minTime) < 1e-5


def test_textgrid_quote_escaping():
    tg = TextGrid(maxTime=1.0)
    tier = IntervalTier("words", 0.0, 1.0)
    tier.add(0.0, 1.0, 'say "hi"')
    tg.append(tier)
    tg2 = read_tg_from_str(write_tg_to_str(tg))
    assert tg2.getFirst("words")[0].mark == 'say "hi"'


def test_point_tier_roundtrip():
    tg = TextGrid(maxTime=2.0)
    pt = PointTier("events", 0.0, 2.0)
    pt.add(0.5, "click")
    pt.add(1.5, "pop")
    tg.append(pt)
    tg2 = read_tg_from_str(write_tg_to_str(tg))
    events = tg2.getFirst("events")
    assert len(events) == 2
    assert events[0].mark == "click" and abs(events[0].time - 0.5) < 1e-6


def test_interval_overlap_rejected():
    tier = IntervalTier("t", 0.0, 1.0)
    tier.add(0.0, 0.6, "a")
    with pytest.raises(ValueError):
        tier.add(0.5, 0.9, "b")
    with pytest.raises(ValueError):
        Interval(0.5, 0.5, "empty")


# ----------------------------------------------------------------- Utterance

def test_utterance_basic_properties(rng, tmp_path):
    wav = (rng.randn(1600) * 1000).astype(np.float64)
    utt = Utterance(wav=wav, fs=16000, text="hello world")
    assert utt.fs == 16000
    assert utt.text == "hello world"
    np.testing.assert_allclose(utt.wav, wav, rtol=1e-6)

    utt.ppg = rng.rand(10, 5).astype(np.float32)
    assert utt.ppg.shape == (10, 5)
    utt.monophone_ppg = rng.rand(10, 3).astype(np.float32)
    assert utt.monophone_ppg.shape == (10, 3)
    utt.lab = np.arange(10)
    assert utt.lab.shape == (10,)
    utt.utterance_id = "utt1"
    utt.speaker_id = "spk1"
    utt.dialect = "EN_CN"
    utt.gender = "F"
    utt.original_file = "/a/b.wav"
    utt.num_channel = 1
    utt.kaldi_shift = 10.0
    utt.kaldi_window_size = 25.0
    utt.kaldi_window_type = "povey"
    utt.vocoder = "WORLD"
    assert utt.dialect == "EN_CN" and utt.gender == "F"
    assert utt.vocoder == "WORLD"
    assert utt.kaldi_shift == 10.0

    # vocoder features with dim side-effects
    utt.spec = rng.rand(10, 513).astype(np.float32)
    assert utt.spec_dim == 513 and utt.fft_size == 1024
    utt.f0 = rng.rand(10).astype(np.float32)
    assert utt.num_frame == 10
    utt.mfcc = rng.rand(10, 13).astype(np.float32)
    assert utt.mfcc_dim == 13

    # serialization roundtrip; the JAX package reads the same bytes
    path = str(tmp_path / "utt.pb")
    utt.write(path)
    j_utt = j_io.Utterance()
    j_utt.read(path)
    assert j_utt.write_internal() == utt.write_internal()
    utt2 = Utterance()
    utt2.read(path)
    assert utt2.text == "hello world"
    assert utt2.utterance_id == "utt1"
    np.testing.assert_allclose(utt2.wav, wav, rtol=1e-6)
    assert utt2.ppg.shape == (10, 5)


def test_utterance_requires_fs_with_wav(rng):
    with pytest.raises(ValueError):
        Utterance(wav=rng.randn(100))
    with pytest.raises(ValueError):
        u = Utterance()
        u.fs = 0


def test_utterance_align_roundtrip():
    tg = TextGrid(maxTime=1.0)
    phones = IntervalTier("phones", 0.0, 1.0)
    phones.add(0.0, 0.5, "AA1")
    phones.add(0.5, 1.0, "sp")
    words = IntervalTier("words", 0.0, 1.0)
    words.add(0.0, 1.0, "WORD")
    tg.append(phones)
    tg.append(words)

    utt = Utterance()
    utt.align = tg
    utt.kaldi_shift = 10.0
    back = utt.align
    assert back.getNames() == ["phones", "words"]

    phone_tier = utt.get_phone_tier()
    assert phone_tier[0].mark == "aa"
    assert phone_tier[1].mark == "sil"
    assert utt.phone[0].mark == "aa"

    word_tier = utt.get_word_tier()
    assert word_tier[0].mark == "word"


def test_textgrid_short_format_parses():
    """The value-stream parser must read Praat's short format, which drops
    all `key =` decoration and item headers."""
    short = '\n'.join([
        'File type = "ooTextFile short"',
        '"TextGrid"',
        '0', '1.5',
        '<exists>',
        '1',
        '"IntervalTier"',
        '"phones"',
        '0', '1.5',
        '2',
        '0', '0.7', '"ah"',
        '0.7', '1.5', '"sil"',
    ]) + '\n'
    tg = read_tg_from_str(short)
    tier = tg.getFirst("phones")
    assert [iv.mark for iv in tier] == ["ah", "sil"]
    assert abs(tier[0].maxTime - 0.7) < 1e-6
    # and it round-trips through the long-format writer
    tg2 = read_tg_from_str(write_tg_to_str(tg))
    assert [iv.mark for iv in tg2.getFirst("phones")] == ["ah", "sil"]


def test_textgrid_multiline_mark_roundtrip():
    tg = TextGrid(maxTime=1.0)
    tier = IntervalTier("notes", 0.0, 1.0)
    tier.add(0.0, 1.0, 'line one\nline "two"')
    tg.append(tier)
    tg2 = read_tg_from_str(write_tg_to_str(tg))
    assert tg2.getFirst("notes")[0].mark == 'line one\nline "two"'


def test_textgrid_rejects_non_praat_text():
    with pytest.raises(ValueError):
        read_tg_from_str('File type = "nonsense"\n"TextGrid"\n0\n1\n0\n')
    with pytest.raises(ValueError):
        read_tg_from_str(
            'File type = "ooTextFile"\nObject class = "Pitch"\n\n'
        )


def test_textgrid_multiline_mark_preserves_interior_whitespace():
    """Whitespace at the end of a physical line INSIDE a quoted mark must
    survive the round trip (the scanner may only trim after the close)."""
    tg = TextGrid(maxTime=1.0)
    tier = IntervalTier("notes", 0.0, 1.0)
    tier.add(0.0, 1.0, "ends with spaces  \nsecond line")
    tg.append(tier)
    tg2 = read_tg_from_str(write_tg_to_str(tg))
    assert tg2.getFirst("notes")[0].mark == "ends with spaces  \nsecond line"


def test_io_read_sym_table_is_the_front_ends():
    """io/ re-exports the front end's one copy (frontend/kaldi_io.py), and
    importing the front end pulls in neither io/ nor protobuf."""
    import subprocess
    import sys

    from fac_via_ppg_torch.frontend import kaldi_io

    assert read_sym_table is kaldi_io.read_sym_table
    code = ("import sys, fac_via_ppg_torch.frontend\n"
            "bad = [m for m in sys.modules if m.startswith("
            "('fac_via_ppg_torch.io', 'google.protobuf'))]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
