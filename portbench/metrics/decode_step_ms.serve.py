"""decode_step_ms.serve: the program's own clock of its decode steps,
the sum of ``Generation.decode_s`` over the sum of the steps, in the
untraced window.  Source: the program's span; moves
``serve_tokens_per_s``."""


def read(r):
    steps = r.program.get("decode_steps", 0)
    if r.kind != "serve" or not steps:
        return None
    return 1e3 * r.program["decode_s"] / steps
