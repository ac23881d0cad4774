from .writer import MIDIFile
from .ezchord import Chord, voice, text_to_pitch, pitch_to_text
from .arpeggio import add_chord, density_bucket, chord_offsets

__all__ = ["MIDIFile", "Chord", "voice", "text_to_pitch", "pitch_to_text",
           "add_chord", "density_bucket", "chord_offsets"]
