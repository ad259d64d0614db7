"""Host time a BFS level: the refresh calls' spans outside the profiled
slice, over their levels."""


def read(rec: dict):
    calls = rec.get("untraced_calls") or []
    levels = sum(n for _, n in calls)
    if not levels:
        return None
    return 1e3 * sum(s for s, _ in calls) / levels
