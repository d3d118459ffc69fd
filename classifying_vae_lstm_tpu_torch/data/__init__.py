from .midi import MidiWriter, parse_smf, quantize_notes, roll_from_smf_bytes
from .pianoroll import PianoData, to_categorical

__all__ = ["MidiWriter", "PianoData", "parse_smf", "quantize_notes",
           "roll_from_smf_bytes", "to_categorical"]
