"""The batch-native solver core (port of ``ida_tpu.core``)."""

from .state import IdaOptions, IdaState, init_state

__all__ = ["IdaState", "IdaOptions", "init_state"]
