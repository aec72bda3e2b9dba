"""Filelists and the int16 scale of the WaveGlow data (the port's copy of
`files_to_list` and `MAX_WAV_VALUE` from fac_via_ppg_tpu/data/mel2samp.py,
reference src/waveglow/mel2samp.py).  The training dataset is not ported
yet."""

from __future__ import annotations

from typing import List

MAX_WAV_VALUE = 32768.0


def files_to_list(filename: str) -> List[str]:
    with open(filename, encoding="utf-8") as f:
        return [line.rstrip() for line in f.readlines()]
