"""Drivers of the model stack (counterpart of `repro.launch`): the serving
loop (`repro_torch.launch.serve`)."""
