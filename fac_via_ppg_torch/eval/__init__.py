from fac_via_ppg_torch.eval.parity import (
    mel_mse,
    run_parity,
    teacher_forced_mel,
)
from fac_via_ppg_torch.eval.rtf import (
    tacotron2_decoder_throughput,
    waveglow_rtf,
)
