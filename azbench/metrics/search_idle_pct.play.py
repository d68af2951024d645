"""The share of the player's span window (``trace_moves`` moves,
``spans``) in which the card sat idle while the host was inside a search:
100 × the idle seconds put down to the ``search`` span and its stages over
the window."""

from azbench import spans


def read(rec):
    if rec is None or rec.counters.get("driver") != "play":
        return None
    return spans.search_idle_pct(spans.of(rec))
