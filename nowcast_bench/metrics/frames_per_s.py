"""frames_per_s (batch mixes): forecast frames completed over the whole
window, on the host's clock: calls x B x T_out / window seconds."""


def read(run):
    if run.kind != "batch":
        return None
    return run.window.calls * run.mix["batch"] * run.cfg["pred_frames"] / run.window.seconds
