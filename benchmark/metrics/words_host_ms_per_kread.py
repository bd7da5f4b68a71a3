"""Self time of the program's `burst.scour.words` span (the host word
lists: `engine._ambig_word_lists`, `_bunch_words_padded`,
`bunch_word_multiset`) per 1,000 reads: its duration less the part its
child spans cover, summed over every batch thread of the traced window."""
from harness import spans


def read(run):
    return spans.self_ms_per_kread(run, "burst.scour.words")
