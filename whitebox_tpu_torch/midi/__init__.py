"""MIDI layer: the note model (``notes``), Standard MIDI File parsing and
writing (``smf``), voice allocation and block-accurate note-event carving
(``voice``), controller lanes (``cc``), all copied from
``whitebox_tpu/midi/``, and the built-in synth (``synth``: the host halves
copied, ``render_synth_chunk`` in torch ops).
"""

from whitebox_tpu_torch.midi.notes import MidiNote, MidiNoteBuffer  # noqa: F401
