"""Control-flow, arithmetic and conversion helpers."""
