from rescan_line_sted_torch.io.native.loader import (  # noqa: F401
    native_available,
    tiff_encode_native,
)
