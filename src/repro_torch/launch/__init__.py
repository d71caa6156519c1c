"""Drivers of the model stack (counterpart of `repro.launch`): the serving
loop (`repro_torch.launch.serve`), the training loop
(`repro_torch.launch.train`), the production mesh and per-arch ctx
(`launch.mesh`), the cells' abstract inputs and shardings
(`launch.specs`), the dry run (`launch.dryrun`) and the hillclimbing
harness (`launch.hillclimb`)."""
from repro_torch.launch.mesh import make_ctx, make_production_mesh

__all__ = ["make_ctx", "make_production_mesh"]
