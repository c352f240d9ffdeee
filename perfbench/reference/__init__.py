"""The benchmark's plain reference: WhisperSeg written from the published
Whisper architecture in float32 PyTorch and float64 NumPy. It imports torch,
numpy and the standard library only, never the measured package."""
