from .corpus import corpus_from_midi_dir, transpose_corpus
from .midi import (
    MidiWriter,
    midi_to_roll,
    parse_smf,
    quantize_notes,
    read_midi_roll,
    roll_from_smf_bytes,
    write_sample,
)
from .pianoroll import (
    PianoData,
    pianoroll_to_song,
    rel_keys,
    relative_major,
    sliding_inds,
    sliding_window,
    song_to_pianoroll,
    songs_to_pianoroll,
    to_categorical,
)
from .wav import render_roll, write_sample_wav

__all__ = ["MidiWriter", "PianoData", "corpus_from_midi_dir", "midi_to_roll", "parse_smf",
           "pianoroll_to_song", "quantize_notes", "read_midi_roll", "rel_keys",
           "relative_major", "render_roll", "roll_from_smf_bytes", "sliding_inds",
           "sliding_window", "song_to_pianoroll", "songs_to_pianoroll", "to_categorical",
           "transpose_corpus", "write_sample", "write_sample_wav"]
