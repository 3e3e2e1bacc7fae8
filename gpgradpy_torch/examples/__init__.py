"""The JAX package's examples on the port (counterparts of ``examples/``).

Each runs as ``python -m gpgradpy_torch.examples.<name>`` on the card
(``--device cpu`` for the CPU) and keeps the JAX example's ``main(...)``
signature and output file, with a ``device`` argument added.  Each splits
its compute part (``compute`` / ``run_one``: torch, numpy and scipy only)
from its plotting, which alone imports matplotlib.
"""
