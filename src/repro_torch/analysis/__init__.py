"""Analysis over the port's collectives, host syncs and kernel budgets
(counterpart of repro.analysis).

HSS's result is a communication bound (rounds x bytes), so every
front-door program carries a `contracts.CommsContract` stating which
collectives it may make, and `python -m repro_torch.analysis.lint` proves
the program matrix against them and writes ANALYSIS_torch.json.

Modules
-------
comms      the collective-cost model over the `Comm` records: every
           all_gather / all_to_all / psum / ragged_all_to_all / ppermute
           with its per-shard operand bytes, axis, and the rounds that
           made it
contracts  declarative CommsContract objects + check_program()
programs   the shipped shard programs, with seeded keys and draws
purity     the documented host syncs, their pinned counts, and the
           exec-cache retrace lint
budgets    Hopper shared-memory and register budgets of the CUDA kernels
lint       the CLI that sweeps the matrix and writes ANALYSIS_torch.json

`programs` and `lint` import the sort front doors, which register their
contracts through this package, so they are imported by name, not here.
"""

from repro_torch.analysis.comms import (  # noqa: F401
    Collective, CommsReport, analyze)
from repro_torch.analysis.contracts import (  # noqa: F401
    CommsContract,
    ContractReport,
    ContractViolation,
    check_batch_invariance,
    check_program,
    get_contract,
    register_contract,
    registered_contracts,
)
