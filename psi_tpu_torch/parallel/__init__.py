"""Multi-device query pipeline (counterpart of psi_tpu/parallel): the
device mesh and the sharded on-path trie and off-path traversal
(mesh.py), the multi-process runtime and the component-sharded index
(distributed.py)."""
