"""Training: SFT (Base → CustomVoice), its data, train-state snapshots and
checkpoint export, and the 25 Hz EMA VQ trainer."""
