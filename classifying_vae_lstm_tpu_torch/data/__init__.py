from .midi import (
    MidiWriter,
    midi_to_roll,
    parse_smf,
    quantize_notes,
    read_midi_roll,
    roll_from_smf_bytes,
    write_sample,
)
from .pianoroll import PianoData, to_categorical
from .wav import render_roll, write_sample_wav

__all__ = ["MidiWriter", "PianoData", "midi_to_roll", "parse_smf", "quantize_notes",
           "read_midi_roll", "render_roll", "roll_from_smf_bytes", "to_categorical",
           "write_sample", "write_sample_wav"]
