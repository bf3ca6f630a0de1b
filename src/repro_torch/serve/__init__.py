"""Multi-tenant serving tier: one Treant, N concurrent sessions."""

from .server import QueueFull, ServeStats, ServerSession, TreantServer

__all__ = ["QueueFull", "ServeStats", "ServerSession", "TreantServer"]
