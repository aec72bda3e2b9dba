from fac_via_ppg_torch.frontend import feat, kaldi_io, mfcc, nnet3, ppg
from fac_via_ppg_torch.frontend.ppg import DependenciesPPG, get_ppg
