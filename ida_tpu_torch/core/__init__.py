"""The batch-native solver core (port of ``ida_tpu.core``)."""
