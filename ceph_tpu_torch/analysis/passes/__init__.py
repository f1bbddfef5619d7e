"""The pass inventory.  A pass is a callable ``(SourceTree) ->
list[Finding]`` carrying ``PASS_ID`` and ``DESCRIBE`` attributes; adding
one means writing the module, importing it here, and appending to
``ALL_PASSES``.  The ids and the order are the reference's
(``ceph_tpu/analysis/passes/__init__.py``)."""

from __future__ import annotations

from .donation import DonationLifetimePass
from .exceptions import ExceptionSwallowPass
from .ledger import LedgerDisciplinePass
from .locks import LockDisciplinePass
from .options_coherence import OptionsCoherencePass
from .purity import JitPurityPass

ALL_PASSES = [
    DonationLifetimePass(),
    JitPurityPass(),
    ExceptionSwallowPass(),
    LockDisciplinePass(),
    OptionsCoherencePass(),
    LedgerDisciplinePass(),
]

PASS_BY_ID = {p.PASS_ID: p for p in ALL_PASSES}
