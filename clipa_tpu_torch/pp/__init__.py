"""Host-side preprocessing: image, augmentation, text and general pp ops.

Port of ``clipa_tpu/pp/``. Importing this package registers its ops with
:class:`clipa_tpu_torch.registry.Registry`. The WordPiece tokenizer stays
in ``clipa_tpu_torch/tokenizer.py``, which serving imports too; the BPE
tokenizer of the CLIPA-v1 configs is ``pp/bpe_tokenizer.py``.
"""

from clipa_tpu_torch.pp import augment  # noqa: F401
from clipa_tpu_torch.pp import autoaugment  # noqa: F401
from clipa_tpu_torch.pp import ops_general  # noqa: F401
from clipa_tpu_torch.pp import ops_image  # noqa: F401
from clipa_tpu_torch.pp import ops_text  # noqa: F401
from clipa_tpu_torch.pp import randaugment  # noqa: F401
