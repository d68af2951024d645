"""The most device memory the allocator held during the self-play window
(``torch.cuda.max_memory_allocated`` after a reset at its start), less one
full move's random draws, which the benchmark makes whole before each move
(the Coach's search draws its tie noise one simulation at a time), GiB."""


def read(rec):
    if rec is None or rec.counters.get("driver") != "selfplay":
        return None
    return (rec.counters["peak_bytes"] - rec.counters["draw_bytes"]) / 2 ** 30
