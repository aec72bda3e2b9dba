from fac_via_ppg_torch.io.textgrid import (
    Interval,
    IntervalTier,
    Point,
    PointTier,
    TextGrid,
)
from fac_via_ppg_torch.io.align import read_tg_from_str, write_tg_to_str
from fac_via_ppg_torch.io.utterance import (
    Utterance,
    get_hardcoded_sym_table,
    is_sil,
    mat_to_numpy,
    normalize_phone,
    normalize_tier_mark,
    normalize_word,
    numpy_to_mat,
    read_segment,
    read_sym_table,
    time_to_frame,
    time_to_frame_interval_tier,
    write_segment,
)
