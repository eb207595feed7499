"""Serving-side pieces of the port (``repro.serve``): so far the packed
record byte model that TOOT prices serve bytes with (``pack.py``)."""
from repro_torch.serve.pack import (  # noqa: F401
    FAT_STEP_BYTES, LABEL_BYTES, predict_record_bytes, walk_bytes_per_request,
)
