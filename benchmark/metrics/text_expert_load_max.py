"""How unevenly the DeepSeek-V2 tower's router loads its experts in bulk
text embedding: the largest expert's rows ÷ the mean expert's, from each
MoE layer's per-expert row counter (``MoE.expert_rows``, read after the
traced stretch), averaged over the traced batches and the MoE layers
(``program_counter``). Moves ``embed_clips_per_s``: the grouped products
wait on the fullest expert."""


def read(run):
    rows = run.stretch.get("expert_rows")
    if not rows:
        return None
    ratios = [max(layer) * len(layer) / sum(layer)
              for batch in rows for layer in batch if sum(layer)]
    return sum(ratios) / len(ratios) if ratios else None
