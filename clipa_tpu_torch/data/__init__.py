"""Data layer: TFRecord IO, data sources, host input pipeline (port of
``clipa_tpu/data``)."""

from clipa_tpu_torch.data.core import DataSource, get_source  # noqa: F401
