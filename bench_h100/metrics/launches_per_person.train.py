"""Device events in the traced stretch of a train cell over the valid
persons it carried."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "train" or not t or not t["traced_persons"]:
        return None
    return t["launches"] / t["traced_persons"]
