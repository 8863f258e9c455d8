from . import windows  # noqa: F401
from .module_utils import (  # noqa: F401
    deprecated,
    fail_with_message,
    is_module_available,
    no_op,
    requires_module,
)
