"""realign_s: the engine a pass (the index and realign stages; realign
ends in torch.cuda.synchronize), the mean over the window's passes."""


def read(ctx):
    vals = [p["stages_s"]["index"] + p["stages_s"]["realign"]
            for p in ctx["passes"] if "realign" in p["stages_s"]]
    return sum(vals) / len(vals) if vals else None
