"""The model zoo: the mask DNN and its RBM pretraining, the Conformers,
the DCSE ``SpeechEnhancer`` and the VQ quantizers."""

from sincformer_tpu_torch.models.dnn import (  # noqa: F401
    SpeechEnhancementDNN, create_dnn)
from sincformer_tpu_torch.models.rbm import (  # noqa: F401
    RBM, pretrain_dnn_with_rbm)
from sincformer_tpu_torch.models.conformer import (  # noqa: F401
    FeedForwardModule, MultiHeadSelfAttention, ConvolutionModule,
    ConformerBlock, ComplexConformer)
from sincformer_tpu_torch.models.dcse import (  # noqa: F401
    SpeechEnhancer)
from sincformer_tpu_torch.models.vq import (  # noqa: F401
    VectorQuantizer, VQMaskQuantizer)
