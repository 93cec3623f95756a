"""decode_wait_ms.<mix kind>: milliseconds a call with nothing on the card,
charged to ``wftk.decode``: the rollout's decode. Each stretch between the
window's operations goes to the innermost port span open on the host at
its middle (``port_spans.py``); summed over the window and divided by
its calls. Nothing when the port logs no spans."""

from nowcast_bench import port_spans


def read(run):
    return port_spans.wait_ms(run, "decode")
