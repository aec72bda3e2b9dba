"""Praat TextGrid <-> string conversion (compat surface; the port's copy of
fac_via_ppg_tpu/io/align.py).

Covers the reference's align.py public pair (src/common/align.py:23-195,
write_tg_to_str / read_tg_from_str), which the Utterance container uses to
store forced alignments inside the DataUtterance proto as a Praat-format
string.  The implementation is NOT a port of that module: serialization
belongs to the object model in io/textgrid.py (`TextGrid.to_praat` /
`TextGrid.from_praat`, a format-agnostic value-stream parser); these two
functions only keep the reference's call signatures and edge behaviors
(None + warning on a non-TextGrid write, time rounding on read).
"""

from __future__ import annotations

import logging
from typing import Optional

from fac_via_ppg_torch.io.textgrid import TextGrid

DEFAULT_TEXTGRID_PRECISION = 5


def write_tg_to_str(tg: TextGrid, null: str = "") -> Optional[str]:
    """TextGrid -> Praat long-format string; None if `tg` is not one."""
    if not isinstance(tg, TextGrid):
        logging.warning(
            "write_tg_to_str got %s instead of a TextGrid; nothing to "
            "serialize", type(tg).__name__,
        )
        return None
    return tg.to_praat(null=null)


def read_tg_from_str(
    tg_str: str, round_digits: int = DEFAULT_TEXTGRID_PRECISION
) -> TextGrid:
    """Praat-format string (long or short) -> TextGrid."""
    return TextGrid.from_praat(tg_str, round_digits=round_digits)
