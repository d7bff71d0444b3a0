"""Host-side data of the port (numpy): the train batch's augmentation and
noise synthesis, and a seeded synthetic clip source."""
