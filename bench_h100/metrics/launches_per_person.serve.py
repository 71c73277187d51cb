"""Device events in the traced stretch of a serve cell over the valid
persons it carried."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "serve" or not t or not t["traced_persons"] or not t["launches"]:
        return None
    return t["launches"] / t["traced_persons"]
