"""Images a ``Predictor.predict`` call carried in a serving cell's measured
window, the calls ``serving.MicroBatcher`` made."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("calls"):
        return None
    return ctx["images"] / ctx["calls"]
