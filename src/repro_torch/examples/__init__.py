"""The port's examples, counterparts of the JAX package's ``examples/``
(kept outside that folder, which the JAX package's lint sweeps).  Run
each as ``python -m repro_torch.examples.<name>``; those that touch a
model take ``--device`` and run on the card unless it says ``cpu``.
``quickstart`` and ``interference_adaptation`` drive the simulator alone
and need no device."""
