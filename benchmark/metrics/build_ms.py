"""Milliseconds a call spends in the program's ``build_runner`` region
(config, pipeline and runner), the mean over the traced window's calls."""


def read(ctx):
    if ctx.spans is None:
        return None
    spans = [e - s for name, s, e in ctx.spans if name == "build_runner"]
    return sum(spans) / len(spans) * 1e3 if spans else None
