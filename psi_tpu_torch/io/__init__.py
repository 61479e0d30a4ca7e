"""Host-side I/O frontends: graph loaders (GFA, vg protobuf) and FASTQ."""

from psi_tpu_torch.io.gfa import load_gfa  # noqa: F401
from psi_tpu_torch.io.vgio import load_vg  # noqa: F401
from psi_tpu_torch.io.fastq import read_fastq  # noqa: F401


def _cache_path(path: str) -> str:
    """Cache entry under ~/.cache keyed by absolute path + mtime — never
    writes next to the (possibly foreign/read-only) source file."""
    import hashlib
    import os

    key = f"{os.path.abspath(path)}:{os.path.getmtime(path)}"
    digest = hashlib.sha256(key.encode()).hexdigest()[:24]
    d = os.path.join(
        os.path.expanduser("~"), ".cache", "psi_tpu_torch", "graphs"
    )
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, digest + ".npz")


def load_graph(path: str, cache: bool = True):
    """Load a sequence graph from a .gfa/.vg file (or a .npz cache) by
    extension; parsed graphs are cached under ~/.cache/psi_tpu_torch keyed by
    source path + mtime."""
    import os

    from psi_tpu_torch.graph import Graph

    if path.endswith(".npz"):
        return Graph.load(path)
    cpath = _cache_path(path) if cache else None
    if cpath and os.path.exists(cpath):
        try:
            return Graph.load(cpath)
        except Exception:
            pass
    if path.endswith(".gfa"):
        g = load_gfa(path)
    elif path.endswith(".vg") or path.endswith(".pb"):
        g = load_vg(path)
    else:
        raise ValueError(f"unsupported graph format: {path}")
    if cpath:
        try:
            g.save(cpath)
        except OSError:
            pass
    return g
