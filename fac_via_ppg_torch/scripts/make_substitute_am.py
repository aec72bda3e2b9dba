"""Generate the substitute PPG resource bundle under data/.

The reference ships its acoustic model as a git-LFS blob that is absent from
the mount (`data/am/final.raw` is listed in .MISSING_LARGE_BLOBS), so the
PPG path cannot be exercised against the original weights.  This script
creates a structurally-equivalent bundle with the same shapes and formats:

  data/am/final.raw.txt   random 40-in / 5816-senone softmax TDNN (nnet3 text)
  data/feats/final.mat    random orthonormal 40x91 LDA (Kaldi binary matrix)
  data/feats/reduce_dim.mat  40x5816 one-hot senone->monophone map
                             (Kaldi binary sparse matrix; sum == 5816)
  data/feats/splice_opts  "--left-context=3 --right-context=3"
  data/arpa_phonemes      40-symbol ARPABET table

The port's copy of fac_via_ppg_tpu/scripts/make_substitute_am.py: the same
seeds and draws, so either package writes the same files.

Usage: python -m fac_via_ppg_torch.scripts.make_substitute_am [out_dir]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from fac_via_ppg_torch.frontend import kaldi_io, nnet3

ARPABET = [
    "aa", "ae", "ah", "ao", "aw", "ay", "b", "ch", "d", "dh", "eh", "er",
    "ey", "f", "g", "hh", "ih", "iy", "jh", "k", "l", "m", "n", "ng", "ow",
    "oy", "p", "r", "s", "sh", "t", "th", "uh", "uw", "v", "w", "y", "z",
    "zh", "sil",
]


def make_bundle(out_dir: str, n_senones: int = 5816, n_phones: int = 40,
                hidden_dim: int = 256, num_layers: int = 3, seed: int = 16807,
                overwrite: bool = True):
    """Write the substitute bundle.  With overwrite=False only MISSING files
    are generated — the lazy DependenciesPPG path uses this so it can never
    clobber artifacts a user has replaced with real ones."""
    # independent stream per artifact: skipping existing files
    # (overwrite=False) must not shift the draws of the others
    rng_lda = np.random.RandomState(seed + 1)
    rng_map = np.random.RandomState(seed + 2)
    os.makedirs(os.path.join(out_dir, "am"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "feats"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "filelists"), exist_ok=True)

    def want(*parts):
        path = os.path.join(out_dir, *parts)
        return path if overwrite or not os.path.exists(path) else None

    path = want("am", "final.raw.txt")
    if path:
        net = nnet3.make_random_tdnn(
            input_dim=40, output_dim=n_senones, hidden_dim=hidden_dim,
            num_layers=num_layers, seed=seed,
        )
        nnet3.write_nnet3_text(net, path)

    # LDA-like 40x91 projection: orthonormal rows over the 91-dim spliced
    # MFCC space (13 ceps x 7 context frames), like the real final.mat.
    path = want("feats", "final.mat")
    if path:
        q, _ = np.linalg.qr(rng_lda.randn(91, 40))
        kaldi_io.write_matrix(path, q.T.astype(np.float32))

    # Senone->monophone map: every senone assigned to exactly one phone.
    path = want("feats", "reduce_dim.mat")
    if path:
        assign = rng_map.randint(0, n_phones, size=n_senones)
        assign[:n_phones] = np.arange(n_phones)  # every phone non-empty
        reduce_dim = np.zeros((n_phones, n_senones), dtype=np.float32)
        reduce_dim[assign, np.arange(n_senones)] = 1.0
        kaldi_io.write_sparse_matrix(path, reduce_dim)

    path = want("feats", "splice_opts")
    if path:
        with open(path, "w") as f:
            f.write("--left-context=3 --right-context=3")

    path = want("arpa_phonemes")
    if path:
        with open(path, "w") as f:
            for i, phone in enumerate(ARPABET):
                f.write(f"{phone}\t{i}\n")

    # Position-dependent phone table (like data/am/phones.txt): eps +
    # silence variants + 4 word-position variants per non-sil phone.
    path = want("am", "phones.txt")
    if not path:
        return
    with open(path, "w") as f:
        idx = 0
        f.write(f"<eps> {idx}\n"); idx += 1
        for sil in ("sil", "sil_B", "sil_E", "sil_I", "sil_S"):
            f.write(f"{sil.upper()} {idx}\n"); idx += 1
        for phone in ARPABET[:-1]:
            for pos in ("B", "E", "I", "S"):
                f.write(f"{phone.upper()}_{pos} {idx}\n"); idx += 1


if __name__ == "__main__":
    default = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..", "data"
    )
    out = sys.argv[1] if len(sys.argv) > 1 else default
    make_bundle(os.path.abspath(out))
    print(f"Substitute PPG bundle written to {os.path.abspath(out)}")
