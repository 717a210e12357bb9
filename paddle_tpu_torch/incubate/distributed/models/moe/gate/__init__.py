from .base_gate import BaseGate  # noqa: F401
from .gshard_gate import GShardGate  # noqa: F401
from .naive_gate import NaiveGate  # noqa: F401
from .switch_gate import SwitchGate  # noqa: F401

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]
