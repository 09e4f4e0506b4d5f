from .local import (  # noqa: F401
    AndGate,
    Channel,
    CompositeGuard,
    OneElementChannel,
    ReceiveBuffer,
    Trigger,
    run_guarded,
)
