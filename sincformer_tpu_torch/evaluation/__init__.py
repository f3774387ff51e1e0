"""The five metrics of evaluation (``sincformer_tpu/evaluation/``), two
tiers each:

  * ``compute_*`` - host signals in, a float out, the reference's
    semantics and fallbacks (pystoi and the ITU PESQ library are used when
    installed), computed on the card unless ``device="cpu"``;
  * ``*_torch`` - torch functions batched over leading axes, what
    ``batched.metrics_batch`` sweeps over a grid cell in one go.
"""

from sincformer_tpu_torch.evaluation.csii import (  # noqa: F401
    compute_csii, csii_torch)
from sincformer_tpu_torch.evaluation.ncm import (  # noqa: F401
    compute_ncm, ncm_torch)
from sincformer_tpu_torch.evaluation.pesq import (  # noqa: F401
    compute_pesq, pesq_proxy_torch)
from sincformer_tpu_torch.evaluation.ssnr import (  # noqa: F401
    compute_ssnr, compute_ssnr_improvement, ssnr_torch)
from sincformer_tpu_torch.evaluation.stoi import (  # noqa: F401
    compute_stoi, stoi_full, stoi_full_torch, stoi_torch)
