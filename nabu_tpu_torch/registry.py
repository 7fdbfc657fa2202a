"""Component registries of the port.

The port keeps its own ``Registry`` and its own registry instances:
registering "dblstm" into the JAX package's ``ENCODERS`` would collide
with the JAX class of the same name, and the port imports nothing of
the JAX package. Each component kind owns a ``Registry`` and classes
self-register under their config-visible name with a decorator.
"""

from __future__ import annotations

from typing import Callable, Dict, TypeVar

T = TypeVar("T")


class Registry:
    """A name -> class map for one pluggable component kind."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, type] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(cls: T) -> T:
            key = name.lower()
            if key in self._entries:
                raise ValueError(
                    f"duplicate {self.kind} registration: {name!r}"
                )
            self._entries[key] = cls
            return cls

        return deco

    def get(self, name: str) -> type:
        key = str(name).lower()
        if key not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; available: "
                f"{sorted(self._entries)}"
            )
        return self._entries[key]

    def build(self, name: str, *args, **kwargs):
        return self.get(name)(*args, **kwargs)

    def names(self):
        return sorted(self._entries)


FEATURE_COMPUTERS = Registry("feature computer")
PROCESSORS = Registry("processor")
TARGET_NORMALIZERS = Registry("target normalizer")
ENCODERS = Registry("encoder")
DECODERS = Registry("decoder")  # model-side decoders (ctc head)
RECOGNIZERS = Registry("recognizer")  # inference-side decoders
LOSSES = Registry("loss")
TRAINERS = Registry("trainer")
EVALUATORS = Registry("evaluator")
