#include "../cuda_host_emu.h"
