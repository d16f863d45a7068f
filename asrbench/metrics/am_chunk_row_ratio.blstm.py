"""The rows the program's chunk windows computed at the recurrences' rate
over the windows' own rows under Kaldi's definition: the counters
`am_chunk_rows` (windows x the widest window's rows, the padding
included) over `am_chunk_rows_needed` across the window (1.0: no padded
row)."""


def read(rec):
    if rec.get("kind") != "bulk_chain_blstm" \
            or not rec.get("am_chunk_rows_needed"):
        return None
    return rec["am_chunk_rows"] / rec["am_chunk_rows_needed"]
