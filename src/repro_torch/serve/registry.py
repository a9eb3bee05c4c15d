"""Index registry: one server process, many named graphs.

Each registered name owns a `DistanceServer` (its own lanes, cache,
metrics, and pre-warmed compiled shapes) over one `ISLabelIndex`; the
registry is just the name → server map plus aggregate stats, so a
multi-tenant front end routes on name and the per-graph engines stay
independent.

The port's copy of ``repro.serve.registry``.
"""
from __future__ import annotations

from repro_torch.serve.engine import DistanceServer


class IndexRegistry:
    def __init__(self):
        self._servers: dict[str, DistanceServer] = {}

    def register(self, name: str, index, **server_kwargs) -> DistanceServer:
        """Wrap ``index`` in a DistanceServer under ``name`` and return
        it. Replacing an existing holder of the name goes through the
        version-drain path (``install``) — never a silent swap that
        drops in-flight requests or leaks pinned versions."""
        server = DistanceServer(index, name=name, **server_kwargs)
        return self.install(name, server)

    def install(self, name: str, server: DistanceServer) -> DistanceServer:
        """Atomically publish ``server`` under ``name``. Any previous
        holder is drained first: its pending batches execute to
        completion (in-flight requests are answered, on their own
        versions) and its retired index versions are released. Only
        then does the name flip to the new server."""
        old = self._servers.get(name)
        if old is not None and old is not server:
            old.drain()
        self._servers[name] = server
        return server

    def unregister(self, name: str) -> None:
        self._servers.pop(name).drain()

    def get(self, name: str) -> DistanceServer:
        try:
            return self._servers[name]
        except KeyError:
            raise KeyError(
                f"no index named {name!r}; registered: {sorted(self._servers)}")

    def names(self) -> list[str]:
        return sorted(self._servers)

    def __len__(self) -> int:
        return len(self._servers)

    def __contains__(self, name: str) -> bool:
        return name in self._servers

    def stats(self) -> dict:
        return {name: srv.stats() for name, srv in self._servers.items()}
