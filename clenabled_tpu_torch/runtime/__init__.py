"""Runtime core: device selection, the Hopper probe and the mesh context."""

from clenabled_tpu_torch.runtime.device import (  # noqa: F401
    DeviceContext,
    card_info,
    get_context,
    get_device,
    mesh_device,
    require_hopper,
    set_default_mesh,
)
