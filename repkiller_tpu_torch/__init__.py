"""repkiller-tpu on PyTorch and CUDA: the self-comparison path of
``repkiller_tpu`` ported to torch tensors, with the banded Gotoh
extension as a hand-written CUDA kernel for Hopper (csrc/banded_gotoh.cu).

Host-only code (Config, FASTA IO, the numpy oracle, writers, family
clustering, Result) is imported from ``repkiller_tpu``, whose package
import pulls in no JAX. Public API: :func:`repkiller_tpu_torch.api.compare`.
"""

from repkiller_tpu.config import Config

from .api import compare

__all__ = ["Config", "compare"]
