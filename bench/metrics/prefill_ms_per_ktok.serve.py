"""``prefill_ms_per_ktok.serve``: the engine's prefill time
(``StreamStats.prefill_s``) over the prompt tokens served in the window, in
ms a thousand tokens."""


def read(run):
    c = run.counters
    if not c.get("prompt_tokens"):
        return None
    return 1e6 * c["prefill_s"] / c["prompt_tokens"]
