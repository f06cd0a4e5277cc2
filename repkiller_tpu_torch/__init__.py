"""repkiller-tpu on PyTorch and CUDA: the pipeline of ``repkiller_tpu``
ported to torch tensors (self and pairwise comparison, ungapped and banded
extension), with both extension kernels hand-written in CUDA for Hopper
(csrc/ungapped_xdrop.cu, csrc/banded_gotoh.cu).

The port imports nothing of ``repkiller_tpu``: it keeps its own copies of
the host-only modules it needs, under the reference's module names
(``config``, ``io/{codec,fasta}``, ``families/cluster`` (host path only),
``report/{csv_writer,intervals}``, ``utils/{capacity,synth}``) and
``api.Result``. ``table`` holds the fragment table's format and rules;
``oracle/{pipeline,banded}`` is the numpy semantics behind
``backend="oracle"``, which production code does not otherwise use.
Public API: :func:`repkiller_tpu_torch.api.compare` and
:func:`repkiller_tpu_torch.api.group_fragments`; the command line is
``python -m repkiller_tpu_torch.cli``.
"""

from .api import compare, group_fragments
from .config import Config

__all__ = ["Config", "compare", "group_fragments"]
