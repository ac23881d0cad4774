"""Framework-wide constants.

Mirrors the reference's compile-time constants (reference:
``utilities/constants.py:50-102``) without any torch dependency. All token-id
layout facts (END/PAD placement, vocab sizes) are load-bearing for checkpoint
and metric parity with the reference, so they are asserted in tests against
the regular structure of the chord vocabulary (see ``core/vocab.py``).
"""

from __future__ import annotations

# --- Chord token vocabulary (reference: utilities/constants.py:50-62) ---
CHORD_END = 157
CHORD_PAD = CHORD_END + 1
CHORD_SIZE = CHORD_PAD + 1  # 159

CHORD_ROOT_END = 13
CHORD_ROOT_PAD = CHORD_ROOT_END + 1
CHORD_ROOT_SIZE = CHORD_ROOT_PAD + 1  # 15

CHORD_ATTR_END = 14
CHORD_ATTR_PAD = CHORD_ATTR_END + 1
CHORD_ATTR_SIZE = CHORD_ATTR_PAD + 1  # 16

# --- Feature padding values (reference: utilities/constants.py:64-82) ---
SEMANTIC_PAD = 0.0
SCENE_OFFSET_PAD = 0.0
SCENE_OFFSET_MAX = 300
MOTION_PAD = 0.0
EMOTION_PAD = 0.0
NOTE_DENSITY_PAD = 0.0
LOUDNESS_PAD = 0.0

# --- Instruments (reference: utilities/constants.py:83-85) ---
INSTRUMENT_SIZE = 40
INSTRUMENT_PAD = 0

# --- Loss / schedule defaults (reference: utilities/constants.py:21-23,86-93) ---
LOSS_LAMBDA = 0.4  # lambda * chord CE + (1 - lambda) * emotion BCE
EMOTION_THRESHOLD = 0.80
ADAM_BETA_1 = 0.9
ADAM_BETA_2 = 0.98
ADAM_EPSILON = 10e-9
LR_DEFAULT_START = 1.0
SCHEDULER_WARMUP_STEPS = 4000

# --- Sequence lengths (reference: utilities/argument_funcs.py:45-47) ---
MAX_SEQ_VIDEO = 300
MAX_SEQ_CHORD = 300
MAX_SEQ_MIDI = 2048

# --- MIDI event vocab (reference: third_party/midi_processor/processor.py:1-21,
#     utilities/constants.py:96-102) ---
RANGE_NOTE_ON = 128
RANGE_NOTE_OFF = 128
RANGE_VEL = 32
RANGE_TIME_SHIFT = 100
TOKEN_END = RANGE_NOTE_ON + RANGE_NOTE_OFF + RANGE_VEL + RANGE_TIME_SHIFT  # 388
TOKEN_PAD = TOKEN_END + 1  # 389
VOCAB_SIZE = TOKEN_PAD + 1  # 390

# --- Emotion classes (6c emotion model; reference: video2music.py:185-188) ---
EMOTION_CLASSES = ("exciting", "fearful", "tense", "sad", "relaxing", "neutral")
N_EMOTIONS = len(EMOTION_CLASSES)

SEPERATOR = "========================="
