"""Device ms a step in the kernels that the configuration names as batch
norm (`batchnorm_kernels`, regular expressions); nothing where it names
none or none ran."""

UNIT = "ms"


def read(ctx):
    patterns = ctx["cell"].config.get("batchnorm_kernels") or []
    if not patterns:
        return None
    sl = ctx["slice"]
    seconds = sl.seconds("|".join(f"(?:{p})" for p in patterns))
    return 1e3 * seconds / sl.steps if seconds > 0 else None
