from fac_via_ppg_torch.dsp.mel import mel_filterbank
from fac_via_ppg_torch.dsp.stft import (
    STFT,
    TacotronSTFT,
    dynamic_range_compression,
    dynamic_range_decompression,
    griffin_lim,
    hann_window,
    window_sumsquare,
)
