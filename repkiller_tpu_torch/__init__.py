"""repkiller-tpu on PyTorch and CUDA: the pipeline of ``repkiller_tpu``
ported to torch tensors (self and pairwise comparison, ungapped and banded
extension), with both extension kernels hand-written in CUDA for Hopper
(csrc/ungapped_xdrop.cu, csrc/banded_gotoh.cu).

Host-only code (Config, FASTA IO, the numpy oracle, writers, family
clustering, Result) is imported from ``repkiller_tpu``, whose package
import pulls in no JAX. Public API: :func:`repkiller_tpu_torch.api.compare`
and :func:`repkiller_tpu_torch.api.group_fragments`; the command line is
``python -m repkiller_tpu_torch.cli``.
"""

from repkiller_tpu.config import Config

from .api import compare, group_fragments

__all__ = ["Config", "compare", "group_fragments"]
