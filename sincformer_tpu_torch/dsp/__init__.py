"""The signal-processing front-end: STFT, the gammatone filterbank, the
Meddis hair cell and the DNN's features."""

from sincformer_tpu_torch.dsp.stft import (  # noqa: F401
    stft, istft, stft_uncentered)
from sincformer_tpu_torch.dsp.gammatone import (  # noqa: F401
    erb_bandwidth, erb_space, gammatone_impulse_response,
    GammatoneFilterbank)
from sincformer_tpu_torch.dsp.haircell import (  # noqa: F401
    MeddisHairCell)
from sincformer_tpu_torch.dsp.features import (  # noqa: F401
    extract_ams, extract_rasta_plp, extract_mfcc, extract_gfcc,
    FeatureExtractor, mel_filterbank, hz_to_mel, mel_to_hz, hz_to_bark,
    bark_to_hz)
