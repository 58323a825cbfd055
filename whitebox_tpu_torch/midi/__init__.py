"""MIDI layer: the note model only (``notes``), copied from
``whitebox_tpu/midi/notes.py`` because sessions and projects hold notes.
SMF parsing, voices and the synth arrive with ROADMAP.md queue 1, item 5.
"""

from whitebox_tpu_torch.midi.notes import MidiNote, MidiNoteBuffer  # noqa: F401
