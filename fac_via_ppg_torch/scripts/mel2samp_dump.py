"""Mel-spectrogram dump CLI (the port of fac_via_ppg_tpu/scripts/
mel2samp_dump.py; reference src/waveglow/mel2samp.py:119-147): takes a
filelist of clean audio and writes one mel .npy file per wav, (n_mel, T)
float32, for vocoder test sets.  The mel is the port's TacotronSTFT
(data/mel2samp.py) on the CUDA card; `main(argv, device="cpu")` runs it
on the CPU.

    python -m fac_via_ppg_torch.scripts.mel2samp_dump -f files.txt \
        -c config.json -o outdir
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from fac_via_ppg_torch.configs import DEFAULT_WAVEGLOW_CONFIG_PATH
from fac_via_ppg_torch.data.mel2samp import Mel2Samp, files_to_list
from fac_via_ppg_torch.frontend import feat as feat_mod
from fac_via_ppg_torch.utils.device import resolve_device


def main(argv: Optional[List[str]] = None, device=None) -> List[str]:
    """Run the CLI on `argv` on `device` (None means the CUDA card);
    returns the .npy paths written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-f", "--filelist_path", required=True)
    parser.add_argument("-c", "--config", type=str,
                        default=DEFAULT_WAVEGLOW_CONFIG_PATH,
                        help="JSON file for configuration")
    parser.add_argument("-o", "--output_dir", type=str, required=True)
    args = parser.parse_args(argv)

    with open(args.config) as f:
        data_config = json.loads(f.read())["data_config"]
    data_config["training_files"] = args.filelist_path
    mel2samp = Mel2Samp(**data_config, device=resolve_device(device))

    os.makedirs(args.output_dir, exist_ok=True)
    written = []
    for filepath in files_to_list(args.filelist_path):
        _, audio = feat_mod.read_wav(filepath)
        melspectrogram = mel2samp.get_mel(audio.astype(np.float32))
        new_filepath = os.path.join(args.output_dir,
                                    os.path.basename(filepath) + ".npy")
        print(new_filepath)
        np.save(new_filepath, melspectrogram)
        written.append(new_filepath)
    return written


if __name__ == "__main__":
    main()
