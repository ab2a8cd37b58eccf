"""Round trips: the analysis, then the synthesis, of a fresh batch per
call.  The traffic file sets ``batch`` (items per call) and
``warmup_calls``.

A call ends once the device has finished it (a synchronise).  The harness
keeps one call of the window, drawn from the seed (:meth:`Loop.keep`), and
after the window the plain reference judges every band and the
reconstruction of that call.
"""

from __future__ import annotations

from .. import common
from ..reference import checks
from . import base


class Loop(base.Loop):
    out = kept = None

    def setup(self) -> None:
        for w in range(self.mix["warmup_calls"]):
            self.call(self.make_input(-1 - w))
            self.finish()
            self.drop()

    def call(self, x) -> None:
        coeffs = self.backend.analysis(x, self.config["wavelet"])
        self.out = (coeffs, self.backend.synthesis(coeffs, self.config["wavelet"]))

    def finish(self) -> None:
        common.sync(self.device)

    def keep(self, index: int) -> None:
        self.kept = (index, self.out)

    def drop(self) -> None:
        self.out = None

    def check(self) -> dict:
        index, (coeffs, rec) = self.kept
        self.kept = None
        return checks.roundtrip(self.make_input(index), coeffs, rec, self.config, self.mix["reference_block"])
