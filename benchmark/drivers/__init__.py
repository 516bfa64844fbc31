"""One driver a configuration ``kind``: ``drivers/<kind>.py`` defines
``Driver(config, traffic, seed, card)``, whose construction is the set-up
(the program's entry built, the inputs made on the card from the seed,
the cell's shapes warmed up) and which has:

- ``window(seconds, tracer)``: the measured window (a traced one
  lengthened by the seconds ``tracer.step`` returns); returns
  ``{"attempted": n, "metrics": {name: value}}`` with the kind's
  end-to-end metrics;
- ``answers()``: what the timed path produced, kept for the comparison;
- ``release()``: frees the program's state (the inputs stay);
- ``judge(answers)``: ``({number: value}, failed)`` against the plain
  reference;
- ``control()``: answers of the reference computed one precision below
  the configuration's, in the shape of ``answers()``;
- ``params``: the shapes the per-layer readers need;
- ``phases``: seconds of each part of its set-up (``Phases``).
"""

import random
import time


class Phases(dict):
    """Seconds of each part of a set-up: ``mark(name)`` closes the part
    begun at the previous mark (or at construction)."""

    def __init__(self):
        super().__init__()
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self[name] = now - self._t
        self._t = now


def sampled(seed: int, stride: int):
    """The steps whose answers a run keeps: those ≡ an offset drawn from
    the seed, modulo ``stride``."""
    offset = random.Random(seed).randrange(stride)
    return lambda k: k % stride == offset
