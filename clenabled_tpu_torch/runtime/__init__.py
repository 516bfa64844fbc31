"""Runtime core: device selection and the Hopper probe."""

from clenabled_tpu_torch.runtime.device import (  # noqa: F401
    card_info,
    get_device,
    require_hopper,
)
