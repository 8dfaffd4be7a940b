"""Multi-GPU training (port of parallel/): the process-group mesh, the
explicit collectives (`mesh.py`) and row-sharded rendering (`render_sp.py`)."""
