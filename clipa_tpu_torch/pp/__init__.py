"""Host-side preprocessing: image, augmentation, text and general pp ops.

Port of ``clipa_tpu/pp/``. Importing this package registers its ops with
:class:`clipa_tpu_torch.registry.Registry`. The WordPiece tokenizer stays
in ``clipa_tpu_torch/tokenizer.py``, which serving imports too. Not ported
yet: the AutoAugment and RandAugment ops and the BPE tokenizer (ROADMAP
A3, A9).
"""

from clipa_tpu_torch.pp import augment  # noqa: F401
from clipa_tpu_torch.pp import ops_general  # noqa: F401
from clipa_tpu_torch.pp import ops_image  # noqa: F401
from clipa_tpu_torch.pp import ops_text  # noqa: F401
