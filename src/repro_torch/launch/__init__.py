"""Entry points (port of ``repro.launch``'s CLIs):
``python -m repro_torch.launch.serve`` serves a batch of requests in
process, ``python -m repro_torch.launch.server`` serves them over HTTP/SSE;
both take the flags of :mod:`repro_torch.launch.cli`.
``python -m repro_torch.launch.train`` trains. Importing a module here
starts nothing: each entry point runs under its ``__main__`` check."""
