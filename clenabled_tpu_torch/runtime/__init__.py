"""Runtime core: device selection, the Hopper probe, the mesh context, the
stream dtype codes and the frame-size policy (``runtime.config``)."""

from clenabled_tpu_torch.runtime.dtypes import (  # noqa: F401
    DTYPE_COMPLEX,
    DTYPE_FLOAT,
    DTYPE_INT,
    DTYPE_SHORT,
    DTYPE_BYTE,
    DTYPE_PACKEDXY,
    dtype_of,
    itemsize_of,
)
from clenabled_tpu_torch.runtime.device import (  # noqa: F401
    DeviceContext,
    card_info,
    get_context,
    get_device,
    mesh_device,
    require_hopper,
    reset_context,
    set_default_mesh,
)
