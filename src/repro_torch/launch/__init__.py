"""Drivers of the model stack (counterpart of `repro.launch`): the serving
loop (`repro_torch.launch.serve`) and the training loop
(`repro_torch.launch.train`)."""
