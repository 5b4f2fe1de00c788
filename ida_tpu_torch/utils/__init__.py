"""Control-flow, arithmetic and conversion helpers."""

from .tree import masked_while_loop, set1, set_row, take1, take_row, tree_where

__all__ = ["tree_where", "masked_while_loop", "take1", "take_row", "set_row", "set1"]
