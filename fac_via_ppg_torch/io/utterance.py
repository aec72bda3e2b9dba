"""Protobuf-backed Utterance container (the port of
fac_via_ppg_tpu/io/utterance.py).

Same public surface as the reference (src/common/utterance.py:43-827): a
DataUtterance proto wrapped with typed property accessors for waveform,
PPGs, alignments, vocoder features, and metadata, plus the time/frame and
phone-normalization helpers the data tooling uses.  Serialized files
interchange with the reference (the schema is wire-compatible).
`read_sym_table` is frontend/kaldi_io.py's, re-exported: the front end
keeps the one copy, so that it never imports protobuf.  No serving or
training path imports this package.
"""

from __future__ import annotations

import logging
import math
import re

import numpy as np
from numpy import ndarray
from scipy.io import wavfile

from fac_via_ppg_torch.frontend.kaldi_io import read_sym_table  # noqa: F401
from fac_via_ppg_torch.io.align import read_tg_from_str, write_tg_to_str
from fac_via_ppg_torch.io.proto.data_utterance_pb2 import (
    DataUtterance,
    MetaData,
    Segment,
    VocoderFeature,
)
from fac_via_ppg_torch.io.textgrid import IntervalTier, TextGrid

# 48 Hz is the minimum for an fft_size of 1024 at fs=16 kHz: 3*fs/(fft_size-3)
DEFAULT_F0_FLOOR = 48  # Hz
DEFAULT_F0_CEIL = 400  # Hz
DEFAULT_SHIFT = 5  # ms
DEFAULT_PITCH_TRACKER = "harvest"
DEFAULT_FFT_SIZE = 1024
DEFAULT_MCEP_DIM = 60


def mat_to_numpy(mat) -> ndarray:
    """Matrix message -> ndarray ((num_row, num_col), or (num_col,) when the
    matrix is a row vector — reference utterance.py:43-63 semantics)."""
    num_row = mat.num_row
    num_col = mat.num_col
    flat = np.array(mat.data)
    if num_row > 1:
        return flat.reshape((num_row, num_col))
    return flat.reshape(num_col)


def numpy_to_mat(np_mat: ndarray, mat) -> None:
    """ndarray -> matrix message, in place (clears existing content)."""
    mat.Clear()
    dims = np_mat.shape
    mat.data.extend(np_mat.flatten())
    if np_mat.size > 0:
        if len(dims) > 1:
            mat.num_row = dims[0]
            mat.num_col = dims[1]
        else:
            mat.num_row = 1
            mat.num_col = dims[0]
    else:
        mat.num_row = 0
        mat.num_col = 0


def read_segment(val: Segment) -> IntervalTier:
    """Segment message -> IntervalTier (reference utterance.py:97-117)."""
    symbols = val.symbol
    start_time = mat_to_numpy(val.start_time)
    end_time = mat_to_numpy(val.end_time)
    num_items = val.num_item

    if not (len(symbols) == len(start_time) == len(end_time) == num_items):
        raise ValueError(
            f"Segment message is internally inconsistent: {num_items} items "
            f"declared but {len(symbols)} symbols / {len(start_time)} starts "
            f"/ {len(end_time)} ends"
        )

    interval = IntervalTier(minTime=start_time[0], maxTime=end_time[-1])
    for sym, min_time, max_time in zip(symbols, start_time, end_time):
        interval.add(min_time, max_time, sym)
    return interval


def write_segment(val: IntervalTier, seg: Segment) -> None:
    """IntervalTier -> Segment message, in place."""
    seg.Clear()
    start_time = []
    end_time = []
    for each in val.intervals:
        seg.symbol.append(each.mark)
        start_time.append(each.minTime)
        end_time.append(each.maxTime)
    numpy_to_mat(np.array(start_time), seg.start_time)
    numpy_to_mat(np.array(end_time), seg.end_time)
    seg.num_item = len(val.intervals)


def time_to_frame(t: float, shift: float) -> int:
    """Seconds -> zero-indexed frame at the given shift (ms)."""
    if t < 0:
        raise ValueError(f"cannot frame a negative timestamp ({t} s)")
    frame_idx = int(math.floor(float(t) * 1000 / float(shift)))
    assert frame_idx >= 0, "Frame index should be non-negative."
    return frame_idx


def time_to_frame_interval_tier(time_tier: IntervalTier,
                                shift: float) -> IntervalTier:
    """Convert an IntervalTier from seconds to frames, repairing segments
    shorter than one frame shift (reference utterance.py:161-197)."""
    max_frame = time_to_frame(time_tier.maxTime, shift)
    frame_tier = IntervalTier(time_tier.name, 0, max_frame)

    start_shift = 0
    for each in time_tier.intervals:
        curr_min = time_to_frame(each.minTime, shift)
        if start_shift > 0:
            logging.warning(
                "previous segment borrowed %d frame(s); trimming them off "
                "the front of this one", start_shift,
            )
            curr_min += start_shift
            start_shift = 0
        curr_max = time_to_frame(each.maxTime, shift)
        if curr_min >= curr_max:
            curr_max = curr_min + 1
            start_shift = curr_max - curr_min
            logging.warning(
                "segment shorter than one frame shift; widening it by %d "
                "frame(s)", start_shift,
            )
        if curr_max > frame_tier.maxTime:
            raise ValueError(
                "segment repair pushed past the tier end; the tier has "
                "too many sub-frame segments to repair"
            )
        frame_tier.add(curr_min, curr_max, each.mark)
    return frame_tier


def is_sil(s: str) -> bool:
    return s.lower() in {"sil", "sp", "spn", ""}


def normalize_phone(s: str, is_rm_annotation: bool = True) -> str:
    """Lower-case, stress-free phoneme labels; handles L2-ARCTIC annotations
    of the form 'PH1,PH2,tag' (reference utterance.py:215-240)."""
    t = s.lower()
    parse_tag = re.compile(r"[^a-z,]").sub("", t)
    if is_sil(parse_tag):
        return "sil"
    if len(parse_tag) == 0:
        raise ValueError(f"no phone label recoverable from {s!r}")
    if is_rm_annotation:
        return parse_tag.split(",")[0]
    return parse_tag


def normalize_word(s: str) -> str:
    return s.lower()


def normalize_tier_mark(tier: IntervalTier,
                        mode: str = "NormalizePhoneCanonical") -> IntervalTier:
    if mode not in {"NormalizePhoneCanonical", "NormalizePhoneAnnotation",
                    "NormalizeWord"}:
        raise ValueError(f"unknown tier normalization mode {mode!r}")
    for each in tier.intervals:
        if mode == "NormalizePhoneCanonical":
            each.mark = normalize_phone(each.mark, True)
        elif mode == "NormalizePhoneAnnotation":
            each.mark = normalize_phone(each.mark, False)
        elif mode == "NormalizeWord":
            each.mark = normalize_word(each.mark)
    return tier


def get_hardcoded_sym_table() -> dict:
    """The 40-entry ARPABET table (reference utterance.py:307-319)."""
    return {
        "aa": 0, "ae": 1, "ah": 2, "ao": 3, "aw": 4, "ay": 5, "b": 6,
        "ch": 7, "d": 8, "dh": 9, "eh": 10, "er": 11, "ey": 12, "f": 13,
        "g": 14, "hh": 15, "ih": 16, "iy": 17, "jh": 18, "k": 19, "l": 20,
        "m": 21, "n": 22, "ng": 23, "ow": 24, "oy": 25, "p": 26, "r": 27,
        "s": 28, "sh": 29, "t": 30, "th": 31, "uh": 32, "uw": 33, "v": 34,
        "w": 35, "y": 36, "z": 37, "zh": 38, "sil": 39,
    }


class Utterance:
    """Typed wrapper over the DataUtterance protobuf."""

    def __init__(self, wav: ndarray = None, fs: int = -1, text: str = ""):
        self._data = DataUtterance()
        if wav is None:
            wav = np.array([])
        if wav.size > 0 > fs:
            raise ValueError(
                "an Utterance holding audio needs its sampling rate (fs)"
            )
        self.wav = wav
        self.fs = fs
        self.text = text

    # --------------------------------------------------------- serialization
    def read_internal(self, pb: bytes):
        self._data.ParseFromString(pb)

    def read(self, pb_path: str):
        with open(pb_path, "rb") as reader:
            self.read_internal(reader.read())

    def write_internal(self) -> bytes:
        return self._data.SerializeToString()

    def write(self, pb_path: str):
        with open(pb_path, "wb") as writer:
            writer.write(self.write_internal())

    # ------------------------------------------------------------- pipelines
    def get_phone_tier(self) -> IntervalTier:
        """Frame-aligned, normalized phone tier from the stored alignment."""
        if self.kaldi_shift < 1:
            raise ValueError(
                f"kaldi_shift must be >= 1 ms, got {self.kaldi_shift}"
            )
        if len(self.align) == 0:
            raise ValueError(
                "no stored alignment on this utterance; align it first"
            )
        phone_tier = time_to_frame_interval_tier(
            self.align.getFirst("phones"), self.kaldi_shift
        )
        phone_tier = normalize_tier_mark(phone_tier)
        self.phone = phone_tier
        return phone_tier

    def get_word_tier(self) -> IntervalTier:
        if self.kaldi_shift < 1:
            raise ValueError(
                f"kaldi_shift must be >= 1 ms, got {self.kaldi_shift}"
            )
        if len(self.align) == 0:
            raise ValueError(
                "no stored alignment on this utterance; align it first"
            )
        word_tier = time_to_frame_interval_tier(
            self.align.getFirst("words"), self.kaldi_shift
        )
        word_tier = normalize_tier_mark(word_tier, "NormalizeWord")
        self.word = word_tier
        return word_tier

    def get_monophone_ppg(self, device=None) -> ndarray:
        """Compute + store the monophone PPG from the stored waveform (the
        AM on `device`, None meaning the card)."""
        if self.kaldi_shift < 1:
            raise ValueError(
                f"kaldi_shift must be >= 1 ms, got {self.kaldi_shift}"
            )
        if self.wav.size == 0 or self.fs < 0:
            raise ValueError(
                "To perform alignment, the object must contain valid speech "
                "data and sampling frequency."
            )
        from fac_via_ppg_torch.frontend import ppg as ppg_mod

        deps = ppg_mod.DependenciesPPG()
        self.monophone_ppg = ppg_mod.compute_monophone_ppg(
            self.wav, self.fs, deps.nnet, deps.lda, deps.monophone_trans,
            self.kaldi_shift, device=device,
        )
        return self.monophone_ppg

    def write_audio(self, path: str):
        if self.wav.max() <= 1:  # float-scaled audio
            wavfile.write(path, self.fs, self.wav)
        else:
            wavfile.write(path, self.fs, self.wav.astype(np.int16))

    # ------------------------------------------------------ property surface
    @property
    def data(self) -> DataUtterance:
        return self._data

    @data.setter
    def data(self, val: DataUtterance):
        self._data.CopyFrom(val)

    @property
    def wav(self) -> ndarray:
        return mat_to_numpy(self._data.wav)

    @wav.setter
    def wav(self, val: ndarray):
        numpy_to_mat(val, self._data.wav)

    @property
    def fs(self) -> int:
        return self._data.fs

    @fs.setter
    def fs(self, val: int):
        if val > 0 or val == -1:
            self._data.fs = val
        else:
            raise ValueError(
                f"sampling rate must be positive or the -1 sentinel, got {val}"
            )

    @property
    def text(self) -> str:
        return self._data.text

    @text.setter
    def text(self, val: str):
        self._data.text = val

    @property
    def align(self) -> TextGrid:
        return read_tg_from_str(self._data.align)

    @align.setter
    def align(self, val: TextGrid):
        self._data.align = write_tg_to_str(val)

    @property
    def ppg(self) -> ndarray:
        return mat_to_numpy(self._data.ppg)

    @ppg.setter
    def ppg(self, val: ndarray):
        numpy_to_mat(val, self._data.ppg)

    @property
    def monophone_ppg(self) -> ndarray:
        return mat_to_numpy(self._data.monophone_ppg)

    @monophone_ppg.setter
    def monophone_ppg(self, val: ndarray):
        numpy_to_mat(val, self._data.monophone_ppg)

    @property
    def phone(self) -> IntervalTier:
        return read_segment(self._data.phone)

    @phone.setter
    def phone(self, val: IntervalTier):
        write_segment(val, self._data.phone)

    @property
    def word(self) -> IntervalTier:
        return read_segment(self._data.word)

    @word.setter
    def word(self, val: IntervalTier):
        write_segment(val, self._data.word)

    @property
    def lab(self) -> ndarray:
        return mat_to_numpy(self._data.lab)

    @lab.setter
    def lab(self, val: ndarray):
        val.astype(int)
        numpy_to_mat(val, self._data.lab)

    @property
    def utterance_id(self) -> str:
        return self._data.utterance_id

    @utterance_id.setter
    def utterance_id(self, val: str):
        self._data.utterance_id = val

    @property
    def speaker_id(self) -> str:
        return self._data.meta_data.speaker_id

    @speaker_id.setter
    def speaker_id(self, val: str):
        self._data.meta_data.speaker_id = val

    @property
    def dialect(self) -> str:
        return MetaData.Dialect.Name(self._data.meta_data.dialect)

    @dialect.setter
    def dialect(self, val: str):
        self._data.meta_data.dialect = MetaData.Dialect.Value(val)

    @property
    def gender(self) -> str:
        return MetaData.Gender.Name(self._data.meta_data.gender)

    @gender.setter
    def gender(self, val: str):
        self._data.meta_data.gender = MetaData.Gender.Value(val)

    @property
    def original_file(self) -> str:
        return self._data.meta_data.original_file

    @original_file.setter
    def original_file(self, val: str):
        self._data.meta_data.original_file = val

    @property
    def num_channel(self) -> int:
        return self._data.meta_data.num_channel

    @num_channel.setter
    def num_channel(self, val: int):
        self._data.meta_data.num_channel = val

    @property
    def kaldi_shift(self) -> float:
        return self._data.kaldi_param.shift

    @kaldi_shift.setter
    def kaldi_shift(self, val: float):
        self._data.kaldi_param.shift = val

    @property
    def kaldi_window_size(self) -> float:
        return self._data.kaldi_param.window_size

    @kaldi_window_size.setter
    def kaldi_window_size(self, val: float):
        self._data.kaldi_param.window_size = val

    @property
    def kaldi_window_type(self) -> str:
        return self._data.kaldi_param.window_type

    @kaldi_window_type.setter
    def kaldi_window_type(self, val: str):
        self._data.kaldi_param.window_type = val

    @property
    def vocoder(self) -> str:
        return VocoderFeature.VocoderName.Name(self._data.vocoder_feat.vocoder)

    @vocoder.setter
    def vocoder(self, val: str):
        self._data.vocoder_feat.vocoder = VocoderFeature.VocoderName.Value(val)

    @property
    def spec(self) -> ndarray:
        return mat_to_numpy(self._data.vocoder_feat.filter.spec)

    @spec.setter
    def spec(self, val: ndarray):
        numpy_to_mat(val, self._data.vocoder_feat.filter.spec)
        self.spec_dim = self.spec.shape[1]
        self.fft_size = 2 * (self.spec_dim - 1)

    @property
    def mfcc(self) -> ndarray:
        return mat_to_numpy(self._data.vocoder_feat.filter.mfcc)

    @mfcc.setter
    def mfcc(self, val: ndarray):
        numpy_to_mat(val, self._data.vocoder_feat.filter.mfcc)
        self.mfcc_dim = self.mfcc.shape[1]

    @property
    def mcep(self) -> ndarray:
        return mat_to_numpy(self._data.vocoder_feat.filter.mcep)

    @mcep.setter
    def mcep(self, val: ndarray):
        numpy_to_mat(val, self._data.vocoder_feat.filter.mcep)
        self.mcep_dim = self.mcep.shape[1]

    @property
    def f0(self) -> ndarray:
        return mat_to_numpy(self._data.vocoder_feat.source.f0)

    @f0.setter
    def f0(self, val: ndarray):
        numpy_to_mat(val, self._data.vocoder_feat.source.f0)
        self.num_frame = self.f0.shape[0]

    @property
    def ap(self) -> ndarray:
        return mat_to_numpy(self._data.vocoder_feat.source.ap)

    @ap.setter
    def ap(self, val: ndarray):
        numpy_to_mat(val, self._data.vocoder_feat.source.ap)
        self.ap_dim = self.ap.shape[1]

    @property
    def bap(self) -> ndarray:
        return mat_to_numpy(self._data.vocoder_feat.source.bap)

    @bap.setter
    def bap(self, val: ndarray):
        numpy_to_mat(val, self._data.vocoder_feat.source.bap)
        if self.bap.ndim >= 2:
            self.bap_dim = self.bap.shape[1]
        else:
            self.bap_dim = 1

    @property
    def vuv(self) -> ndarray:
        return mat_to_numpy(self._data.vocoder_feat.source.vuv)

    @vuv.setter
    def vuv(self, val: ndarray):
        numpy_to_mat(val, self._data.vocoder_feat.source.vuv)

    @property
    def temporal_position(self) -> ndarray:
        return mat_to_numpy(self._data.vocoder_feat.source.temporal_position)

    @temporal_position.setter
    def temporal_position(self, val: ndarray):
        numpy_to_mat(val, self._data.vocoder_feat.source.temporal_position)

    @property
    def vocoder_window_size(self) -> float:
        return self._data.vocoder_feat.param.window_size

    @vocoder_window_size.setter
    def vocoder_window_size(self, val: float):
        self._data.vocoder_feat.param.window_size = val

    @property
    def vocoder_window_type(self) -> str:
        return self._data.vocoder_feat.param.window_type

    @vocoder_window_type.setter
    def vocoder_window_type(self, val: str):
        self._data.vocoder_feat.param.window_type = val

    @property
    def vocoder_shift(self) -> float:
        return self._data.vocoder_feat.param.shift

    @vocoder_shift.setter
    def vocoder_shift(self, val: float):
        self._data.vocoder_feat.param.shift = val

    @property
    def num_frame(self) -> int:
        return self._data.vocoder_feat.param.num_frame

    @num_frame.setter
    def num_frame(self, val: int):
        self._data.vocoder_feat.param.num_frame = val

    @property
    def alpha(self) -> float:
        return self._data.vocoder_feat.param.alpha

    @alpha.setter
    def alpha(self, val: float):
        self._data.vocoder_feat.param.alpha = val

    @property
    def fft_size(self) -> int:
        return self._data.vocoder_feat.param.fft_size

    @fft_size.setter
    def fft_size(self, val: int):
        self._data.vocoder_feat.param.fft_size = val

    @property
    def spec_dim(self) -> int:
        return self._data.vocoder_feat.param.spec_dim

    @spec_dim.setter
    def spec_dim(self, val: int):
        self._data.vocoder_feat.param.spec_dim = val

    @property
    def mfcc_dim(self) -> int:
        return self._data.vocoder_feat.param.mfcc_dim

    @mfcc_dim.setter
    def mfcc_dim(self, val: int):
        self._data.vocoder_feat.param.mfcc_dim = val

    @property
    def mcep_dim(self) -> int:
        return self._data.vocoder_feat.param.mcep_dim

    @mcep_dim.setter
    def mcep_dim(self, val: int):
        self._data.vocoder_feat.param.mcep_dim = val

    @property
    def f0_floor(self) -> float:
        return self._data.vocoder_feat.param.f0_floor

    @f0_floor.setter
    def f0_floor(self, val: float):
        self._data.vocoder_feat.param.f0_floor = val

    @property
    def f0_ceil(self) -> float:
        return self._data.vocoder_feat.param.f0_ceil

    @f0_ceil.setter
    def f0_ceil(self, val: float):
        self._data.vocoder_feat.param.f0_ceil = val

    @property
    def timestamp(self) -> str:
        return self._data.vocoder_feat.param.timestamp

    @timestamp.setter
    def timestamp(self, val: str):
        self._data.vocoder_feat.param.timestamp = val

    @property
    def ap_dim(self) -> int:
        return self._data.vocoder_feat.param.ap_dim

    @ap_dim.setter
    def ap_dim(self, val: int):
        self._data.vocoder_feat.param.ap_dim = val

    @property
    def bap_dim(self) -> int:
        return self._data.vocoder_feat.param.bap_dim

    @bap_dim.setter
    def bap_dim(self, val: int):
        self._data.vocoder_feat.param.bap_dim = val

    @property
    def pitch_tracker(self) -> str:
        return self._data.vocoder_feat.param.pitch_tracker

    @pitch_tracker.setter
    def pitch_tracker(self, val: str):
        self._data.vocoder_feat.param.pitch_tracker = val
